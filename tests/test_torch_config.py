"""The port's configuration is its own copy of the JAX package's: the
presets, their parts and the scoring constants compare equal field by
field."""

import dataclasses

import pytest

from pigeon_tpu import config as jax_config
from pigeon_tpu_torch import config


def fields(obj):
    """``obj`` as nested plain values, dataclasses by their field names."""
    if dataclasses.is_dataclass(obj):
        return {f.name: fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return obj


@pytest.mark.parametrize("make", ["pigeon_config", "pigeotto_config",
                                  "vit_l14_336_vision", "VisionConfig",
                                  "HeadConfig", "RefinerConfig",
                                  "TrainConfig", "PigeonConfig"])
def test_presets_equal_the_jax_packages(make):
    got, want = getattr(config, make)(), getattr(jax_config, make)()
    assert type(got).__name__ == type(want).__name__
    assert fields(got) == fields(want)


def test_derived_properties_and_constants_agree():
    for num_cells in (5, 2203):
        got = config.pigeon_config(num_cells)
        want = jax_config.pigeon_config(num_cells)
        assert fields(got) == fields(want)
        assert got.head.input_dim == want.head.input_dim
        assert got.head.views == want.head.views
    vision, jax_vision = config.VisionConfig(), jax_config.VisionConfig()
    for prop in ("num_patches", "seq_len", "head_dim"):
        assert getattr(vision, prop) == getattr(jax_vision, prop)
    assert config.GEOGUESSR_DECAY_KM == jax_config.GEOGUESSR_DECAY_KM
    assert config.GEOGUESSR_MAX_SCORE == jax_config.GEOGUESSR_MAX_SCORE
    assert config.pigeon_config().replace(name="x").name == "x"
