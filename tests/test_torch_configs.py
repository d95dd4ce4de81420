"""The port's YAML presets are the JAX package's: the same parse, key for
key, and the port's dict presets (``SERVING_PRESET``,
``META_CHANNELS_ALL``) equal the YAMLs they stand for.  The port alone
ships the presets of models the JAX package has not (``PORT_ONLY``)."""

from pathlib import Path

import pytest
import yaml

from crimac_unet_tpu.config import load_yaml_config as jax_load
from crimac_unet_tpu_torch import config

REPO = Path(__file__).resolve().parent.parent
JAX_CONFIGS = REPO / "crimac_unet_tpu" / "configs"
PORT_CONFIGS = REPO / "crimac_unet_tpu_torch" / "configs"
NAMES = ["config_baseline.yaml", "config_fast_train.yaml",
         "config_meta_train.yaml", "config_serving.yaml"]
# presets of models the JAX package does not have
PORT_ONLY = ["config_segformer_b2.yaml"]


def test_the_port_ships_the_four_presets():
    assert sorted(p.name for p in PORT_CONFIGS.glob("*.yaml")) == \
        sorted(NAMES + PORT_ONLY)
    assert sorted(p.name for p in JAX_CONFIGS.glob("*.yaml")) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_yaml_parses_as_the_jax_packages(name):
    with open(PORT_CONFIGS / name) as f:
        mine = yaml.safe_load(f)
    with open(JAX_CONFIGS / name) as f:
        ref = yaml.safe_load(f)
    assert mine == ref
    assert config.load_yaml_config(PORT_CONFIGS / name) \
        == jax_load(JAX_CONFIGS / name)
    # the parsed options too (defaults filled in)
    port_opts = config.parse_config_options(
        config.load_yaml_config(PORT_CONFIGS / name))
    for k, v in ref.items():
        assert port_opts[k] == v, k


def test_serving_preset_is_config_serving_yaml():
    with open(PORT_CONFIGS / "config_serving.yaml") as f:
        serving = yaml.safe_load(f)
    assert config.SERVING_PRESET == serving


def test_meta_channels_all_is_config_meta_train_yaml():
    with open(PORT_CONFIGS / "config_meta_train.yaml") as f:
        meta = yaml.safe_load(f)["meta_channels"]
    assert config.META_CHANNELS_ALL == meta
