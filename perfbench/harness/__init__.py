"""What every cell shares: the window, the trace, the checks, the card."""
