"""What every cell shares: finding files by name, traffic, the program's
surface, the trace reader, the reference pool and the result line."""
