"""Test harness config: force the JAX CPU backend with a virtual 8-device
mesh so sharding tests run hermetically without accelerator hardware
(SURVEY.md §4, multi-node without a real cluster).  The replay kernel
runs as its plain lax.scan reference here; tests marked `gpu` need a card
and skip."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import pytest

import jax

from qoipp_tpu.utils.timing import enable_compile_cache

jax.config.update("jax_platforms", "cpu")
# Persistent compile cache: the suite compiles many (shape-bucket, op)
# variants; cache them across runs to keep iteration fast.
enable_compile_cache()

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def load_fixture(name: str) -> np.ndarray:
    return np.frombuffer((FIXTURES / name).read_bytes(), dtype=np.uint8)


@pytest.fixture
def raw3():
    return load_fixture("image_raw_3.bin")


@pytest.fixture
def raw4():
    return load_fixture("image_raw_4.bin")


@pytest.fixture
def qoi3():
    return load_fixture("image_qoi_3.bin")


@pytest.fixture
def qoi4():
    return load_fixture("image_qoi_4.bin")


@pytest.fixture
def qoi3_incomplete():
    return load_fixture("image_qoi_3_incomplete.bin")


@pytest.fixture
def qoi4_incomplete():
    return load_fixture("image_qoi_4_incomplete.bin")
