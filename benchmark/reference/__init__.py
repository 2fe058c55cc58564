"""The benchmark's plain reference: a frozen copy of diffcloth_tpu_torch's
plain PyTorch paths, the route each kernel wrapper takes on CPU tensors
(`detect.py`, `friction.py`, `lstsq.py` keep only those), every step's
program run uncaptured (`graphs.py`), and the scene, constraints, P^{-1},
starts and obstacles built again from a configuration file (`scene.py`).
It imports nothing of the program, so a later change to the program cannot
move what it is judged against.  `judge.py` holds the comparisons."""
