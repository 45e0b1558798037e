"""Host-side helpers: device resolution, hit/miss counters and the
multi-step training helpers (``scan_fit``)."""
