"""Small shared utilities: named locks and event counters."""
