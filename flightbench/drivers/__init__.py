"""One driver a kind of cell: `Driver(cell, config, mix, seed, device)` with
`setup()`, `window(seconds)`, `traced()`, `check()` and the `counters`
that the per-layer metrics' readers read."""
