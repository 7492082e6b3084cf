"""The service knobs a port test may inherit from the process
environment, and the guard that keeps them out.

``ServiceConfig.from_env`` (both packages') reads the whole process
environment, and the JAX package's ``load_env_file`` writes into it:
``tests/test_service_units.py::test_env_file_loader`` leaves
``MODEL_NAME=gemma-2b`` and ``CACHE_TTL=450`` behind (its closing
``monkeypatch.delenv`` records the loaded value, so the undo restores
it). A port test that later builds an engine from the environment in the
same worker then asks for a model neither package knows. The port's
test modules that read the environment import ``knob_env``: an autouse,
module-scoped fixture that removes every knob either ``from_env`` reads
for the module's run and puts the environment back after it.
"""

import os
import re
from pathlib import Path

import pytest

from ai_agent_kubectl_tpu import config as jax_config
from ai_agent_kubectl_tpu_torch import config as port_config
from ai_agent_kubectl_tpu_torch.config import UNSERVED_KNOBS, ServiceConfig


def _knobs_read(module) -> set:
    """The environment variables a config module's from_env reads."""
    src = Path(module.__file__).read_text()
    body = src[src.index("def from_env"):]
    return set(re.findall(r'(?:_env_\w+|os\.getenv)\(\s*"([A-Z_0-9]+)"',
                          body))


#: every knob either package's from_env reads, the refused ones included
KNOBS = frozenset(_knobs_read(jax_config) | _knobs_read(port_config)
                  | set(UNSERVED_KNOBS))


@pytest.fixture(scope="module", autouse=True)
def knob_env():
    """No service knob from outside the module reaches its tests."""
    with pytest.MonkeyPatch.context() as mp:
        for name in KNOBS & set(os.environ):
            mp.delenv(name)
        yield


def test_knobs_cover_the_names_a_leak_left_behind():
    assert {"MODEL_NAME", "CACHE_TTL", "CHUNK_PIPE_DEPTH", "TORCH_DEVICE",
            "MESH_SHAPE"} <= KNOBS
    assert len(KNOBS) > 100


@pytest.mark.parametrize("name,value", [("MODEL_NAME", "gemma-2b"),
                                        ("CACHE_TTL", "450")])
def test_a_leaked_knob_is_gone_inside_a_guarded_module(name, value):
    """The values ``test_env_file_loader`` leaves behind: a later
    guarded module reads the defaults."""
    default = getattr(ServiceConfig(), name.lower())
    with pytest.MonkeyPatch.context() as outside:
        outside.setenv(name, value)
        gen = knob_env.__wrapped__()
        next(gen)
        try:
            assert name not in os.environ
            cfg = ServiceConfig.from_env(env_file=None)
            assert getattr(cfg, name.lower()) == default
        finally:
            with pytest.raises(StopIteration):
                next(gen)
        assert os.environ[name] == value
