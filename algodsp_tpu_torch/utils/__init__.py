"""Shared utilities: elliptic-function math, polynomial root helpers,
the built-in IR set."""
