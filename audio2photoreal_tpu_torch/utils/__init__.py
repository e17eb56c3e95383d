"""Host-side utilities: timing and tracing."""
