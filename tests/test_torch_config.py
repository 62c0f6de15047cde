"""The port's configs copy the JAX package's field for field."""
import dataclasses

import pytest

from repro.configs import base as jax_base
from repro.configs import rankgraph2 as jax_rg2
from repro_torch.configs import base as port_base
from repro_torch.configs import rankgraph2 as port_rg2


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        else:
            default = dataclasses.MISSING
        out.append((f.name, f.type, default))
    return out


@pytest.mark.parametrize("name", ["RQConfig", "RankGraph2Config"])
def test_fields_and_defaults_match(name):
    jax_f = _fields(getattr(jax_base, name))
    port_f = _fields(getattr(port_base, name))
    assert [f[:2] for f in port_f] == [f[:2] for f in jax_f]
    for (fname, _, dj), (_, _, dp) in zip(jax_f, port_f):
        if dataclasses.is_dataclass(dj):
            assert dataclasses.asdict(dp) == dataclasses.asdict(dj), fname
        else:
            assert dp == dj, fname


def test_rankgraph2_config_and_shapes_match():
    assert (dataclasses.asdict(port_rg2.CONFIG)
            == dataclasses.asdict(jax_rg2.CONFIG))
    assert port_rg2.CONFIG.dtype == "bfloat16"
    assert ([(s.name, s.step, s.dims) for s in port_base.RANKGRAPH2_SHAPES]
            == [(s.name, s.step, s.dims)
                for s in jax_base.RANKGRAPH2_SHAPES])
