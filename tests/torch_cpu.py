"""Shared set-up of the port's CPU tests.

``one_torch_thread``: an autouse fixture that runs a test module's torch
code on one intra-op thread. pytest-xdist runs the test files in several
worker processes at once, and with torch's default of one OpenMP thread per
core in each, the workers' threads oversubscribe the cores: a render that
takes seconds alone then takes minutes. Alone, one thread is about as fast
at the tests' small sizes. A module takes the fixture by importing it.

``jax_cfg`` / ``jax_eps``: the JAX package's own ``RenderConfig`` /
``Epsilons`` with the fields of the port's, so that each package is handed
its own configuration.
"""

import dataclasses

import pytest
import torch

from raytracer_tpu import config as jax_config


def jax_eps(eps) -> jax_config.Epsilons:
    return jax_config.Epsilons(**dataclasses.asdict(eps))


def jax_cfg(cfg) -> jax_config.RenderConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["eps"] = jax_eps(cfg.eps)
    return jax_config.RenderConfig(**fields)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
