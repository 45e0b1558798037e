"""Host-side helpers: device resolution and hit/miss counters."""
