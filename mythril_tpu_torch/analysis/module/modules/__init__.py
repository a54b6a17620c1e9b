"""The built-in detection modules (reference analysis/module/modules/)."""
