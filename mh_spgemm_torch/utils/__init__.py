"""Host-side helpers (native host library binding)."""
