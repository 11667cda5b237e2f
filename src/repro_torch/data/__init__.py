"""The deterministic synthetic token pipeline (``repro.data``)."""
