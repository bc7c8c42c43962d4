"""The benchmark of zkm_tpu_torch on the card: `python3 zkbench/run.py`.

Nothing here imports JAX or the JAX package (`zkm_tpu`); only
`system.py` calls into the port, and `reference/` imports nothing of it.
"""
