"""Visuals, progress bookkeeping, loss logging and profiling."""
