"""OpenFOAM case and blockMeshDict generation (text writers)."""

from .casegen import write_blockmesh_dict, write_openfoam_case, write_mirror_mesh_dict
