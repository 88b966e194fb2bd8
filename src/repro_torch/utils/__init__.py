"""Host-side helpers of the port: tree key paths and the event log."""
