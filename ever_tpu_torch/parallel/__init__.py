"""Train and eval steps (``spmd``); the parallel layouts are not ported yet."""
