"""Step executors (single device; the multi-device strategies are queued)."""
