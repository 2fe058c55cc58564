"""The `diffcloth_py` surface of the port: the stateful `SimulationAPI`
(pysim.py) and the PyTorch autograd bridge (torch_bridge.py)."""
