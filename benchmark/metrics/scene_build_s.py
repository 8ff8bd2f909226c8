"""Seconds of the program's build_scene for a mesh scene (BVH, clusters,
orientation gate, upload), on the host clock in set-up."""


def read(trace):
    return trace.host.get('scene_build_s')
