"""The regen engine's glue a crewmate frame, in ms, read as the unicorn's
(``glue_ms_per_frame.unicorn.py``): the traced run's own ``frame_s`` less
the device time a profiled frame spent in K2 (``bvh8_kernel``) and K3
(``key_kernel``)."""

from rtbench import spec

read = spec.metric_reader("glue_ms_per_frame.unicorn")
