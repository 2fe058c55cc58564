"""The benchmark's own tests: CPU at tiny sizes, and the `cuda` cases on a
card.  Imports nothing of JAX."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


# each cell at a size a CPU test holds: the sphere's 10 x 10 grid over 80
# steps, so that the cloth drapes on the sphere, four episodes
TINY = {
    "sphere_mu": {"config": {"scene": {"fabric": {"grid_num_x": 10,
                                                  "grid_num_y": 10},
                                       "step_num": 80},
                             "population": 4},
                  "traffic": {"chunk": 20,
                              "check": {"episodes_per_evaluation": 2}}},
}
# the same grid over 250 steps: from about step 125 on the cloth also meets
# itself, so the self-friction sweeps hold slots
CONTACT = {
    "sphere_mu": {"config": {"scene": {"fabric": {"grid_num_x": 10,
                                                  "grid_num_y": 10},
                                       "step_num": 250},
                             "population": 4},
                  "traffic": {"chunk": 25,
                              "check": {"episodes_per_evaluation": 2}}},
}


def tiny(cell: str) -> dict:
    return TINY[cell.split(".")[0]]


def contact(cell: str) -> dict:
    return CONTACT[cell.split(".")[0]]
