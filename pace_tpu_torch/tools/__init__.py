"""Post-processing and profiling tools: the diagnostics format converter,
quick-look plots and the one-step profile."""
