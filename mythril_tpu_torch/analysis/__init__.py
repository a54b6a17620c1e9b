"""Analysis layer: detection modules, solver helpers, reports."""
