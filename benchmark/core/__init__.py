"""What every cell shares: the cell's files, its inputs, the round driver,
the traced rounds and the yardstick."""
