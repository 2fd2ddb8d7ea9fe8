"""The regen engine's glue a frame, in ms: the traced run's own
``frame_s``, taken in its window before the profiled frames (host clock:
the profiler slows the frames it records about twofold), less the device
time a profiled frame spent in the BVH traversal
(K2, ``bvh8_kernel``) and coherence-key (K3, ``key_kernel``) kernels as
the trace names them."""


def read(ctx):
    frames = ctx.out.get("traced_frames") or []
    wall = ctx.out.get("frame_s")
    k2, n2 = ctx.summary.kernel_us("bvh8_kernel")
    if not frames or wall is None or n2 == 0:
        return None
    k3, _ = ctx.summary.kernel_us("key_kernel")
    return (wall - (k2 + k3) / 1e6 / len(frames)) * 1e3
