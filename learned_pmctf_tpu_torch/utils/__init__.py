"""Host-side helpers: stream containers, metrics, YUV and JSON I/O,
training schedules, logging and checkpoints."""
