"""Distribution over torch.distributed: image rows shard over ranks, the
scene, tables, sun, camera, material parameters and the radiance cache
replicate (as `nebulae_tpu/dist/`).

  mesh.py    init_distributed, World (rank, size, device, backend, rows),
             shard_frame_state
  comm.py    every collective the port issues, each one logged
  stats.py   collective_stats, shard_balance
  runner.py  DistRenderer, present_gather, gather_state
  dryrun.py  the multi-rank dry run and its per-rank worker
"""
