"""The share of the regen loop's steps that ran as a replay of a captured
CUDA graph in a crewmate frame, in percent, read as the unicorn's
(``regen_graph_step_pct.unicorn.py``): the program's counter
``regen.graph_steps`` over ``regen.steps``."""

from rtbench import spec

read = spec.metric_reader("regen_graph_step_pct.unicorn")
