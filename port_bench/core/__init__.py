"""What every cell shares: finding a cell's files by name, the card, the
seeded weights and scenes, the trace and its reduction, the comparisons."""
