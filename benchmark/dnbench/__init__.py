"""The benchmark's harness: the cell's data (spec), inputs from the seed,
frozen counts, the trace's reduction and the comparison that decides
`correct`."""
