from .mesh import make_overlap_mesh, sharded_overlap_step  # noqa: F401
