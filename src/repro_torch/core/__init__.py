"""Core: packed bitmaps, gate circuits and their byte code, the dense
threshold algorithms and the cost-model planner (port of ``repro.core``)."""
