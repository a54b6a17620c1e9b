"""The runners, one module a traffic kind: runners/<kind>.py exposes
`run(cell, seed, seconds, traced, device, control=None, clock=None)` and
returns a common.RunRecord. port_bench.run finds it by the mix's "kind"."""
