"""IO: trajectory export / import and offline rendering (counterpart of
`diffcloth_tpu/io`; reference `exportSimulation`, Simulation.cpp:4195,
`resetForwardRecordsFromFolder`, Simulation.h:574, and the Viewer).
The viewer imports matplotlib only when it renders."""
from diffcloth_tpu_torch.geometry.objio import (export_frames, import_frames,
                                                load_obj, save_obj)
from diffcloth_tpu_torch.io.export import (export_episode, export_frame_info,
                                           import_episode)
from diffcloth_tpu_torch.io.viewer import render_episode, render_frame

__all__ = [
    "export_frames", "import_frames", "load_obj", "save_obj",
    "export_episode", "export_frame_info", "import_episode",
    "render_episode", "render_frame",
]
