"""Symbolic machine/world state objects carried by every explored path."""
