"""Launchers of the port: `serve`, the serving CLI, `train`, the training
CLI, and the distributed layer: `mesh` (device meshes and the H100's
constants), `shardings` (the sharding rules as DTensor layouts),
`dryrun` (the fake-mesh dry run) and `roofline` (its H100 roofline)."""
