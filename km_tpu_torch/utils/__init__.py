"""Phase timers and the torch.profiler device trace."""
