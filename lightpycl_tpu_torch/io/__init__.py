"""File formats. Port counterpart of lightpycl_tpu/io: the same exports.
Every format is a jax-free copy of the reference's, and the checkpoint and
ray file read and write the reference's files."""

from lightpycl_tpu_torch.io.dxf import (DXFWriter, load_dxf_mesh,
                                        load_dxf_scene, save_traced_scene)
from lightpycl_tpu_torch.io.checkpoint import load_state, save_state
from lightpycl_tpu_torch.io.ies import (IESData, ies_source, load_ies,
                                        save_ies, luminous_intensity_grid)
from lightpycl_tpu_torch.io.rayfile import (RayFileData, RayFileSource,
                                            load_rayfile,
                                            save_measured_rayfile,
                                            save_rayfile)
from lightpycl_tpu_torch.io.obj import (load_obj, load_obj_scene, load_ply,
                                        save_obj, save_ply)
from lightpycl_tpu_torch.io.stl import load_stl, save_stl
from lightpycl_tpu_torch.io.zmx import (ZmxPrescription, ZmxSurface,
                                        load_zmx, save_zmx, zmx_paraxial,
                                        zmx_to_scene)
from lightpycl_tpu_torch.io.seq import load_seq, seq_paraxial, seq_to_scene
from lightpycl_tpu_torch.io.scene import load_scene, save_scene

__all__ = ["DXFWriter", "save_traced_scene", "load_dxf_mesh",
           "load_dxf_scene", "save_state", "load_state",
           "load_stl", "save_stl", "IESData", "ies_source", "load_ies",
           "save_ies", "luminous_intensity_grid", "RayFileData",
           "RayFileSource", "load_rayfile", "save_rayfile",
           "save_measured_rayfile", "load_obj", "load_obj_scene", "save_obj",
           "load_ply", "save_ply", "ZmxPrescription", "ZmxSurface",
           "load_zmx", "save_zmx", "zmx_paraxial", "zmx_to_scene",
           "load_seq", "seq_paraxial", "seq_to_scene",
           "load_scene", "save_scene"]
