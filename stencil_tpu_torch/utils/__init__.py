"""Host-side helpers: statistics, timers, logging, device sync."""
