"""Multi-device rendering: hemisphere rows sharded over a device mesh."""
