"""The plain reference: float32 PyTorch, no kernel, no cache, no batching
tricks.  ``network.py`` and the modules it imports are frozen copies of the
measured program's plain path (its bundle-head kernel written out as
layers, its bf16 casts and row sharding taken out), ``losses.py`` and
``train_step.py`` the training recipe's loss and step, ``scenes.py`` and
``weights.py`` the seeded inputs both sides read, ``precision.py`` the
lower-precision controls.  Nothing here imports the measured program or
JAX (``tests/test_bench_guard.py``)."""
