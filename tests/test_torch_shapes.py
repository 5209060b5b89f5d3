"""The port's shape suites, input specs and sample batches against the
reference's (``repro.configs.shapes``), and the machine-model fields the
roofline reads (``hbm_bytes``, ``dcn_bw``, ``compute_seconds``,
``memory_seconds``) against ``repro.core.machine``."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.configs import list_configs
from repro.configs import shape_for as j_shape_for
from repro.configs.shapes import ShapeSuite as JShapeSuite
from repro.configs.shapes import cell_applicable as j_cell_applicable
from repro.configs.shapes import sample_batch as j_sample_batch
from repro.core import machine as jmachine

from repro_torch import configs as tconfigs
from repro_torch.configs import SHAPES, get_config, input_specs, shape_for
from repro_torch.configs.shapes import (ShapeSuite, cell_applicable,
                                        sample_batch)
from repro_torch.core import machine as tmachine

ARCHS = list_configs()
CELLS = list(itertools.product(ARCHS, list(J_SHAPES)))
_DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32,
           jnp.bfloat16: torch.bfloat16}


def _torch_dtype(jdtype):
    return next(t for j, t in _DTYPES.items() if jnp.dtype(j) == jdtype)


def test_same_architectures():
    assert tconfigs.list_configs() == ARCHS and len(ARCHS) == 10


@pytest.mark.parametrize("name", list(J_SHAPES))
def test_shape_suite(name):
    ref, port = J_SHAPES[name], SHAPES[name]
    assert (port.name, port.seq_len, port.global_batch, port.kind) == \
        (ref.name, ref.seq_len, ref.global_batch, ref.kind)
    assert shape_for(name) == port and j_shape_for(name) == ref


def test_shape_table_keys():
    assert list(SHAPES) == list(J_SHAPES)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_applicable(arch, shape):
    want = j_cell_applicable(j_get_config(arch), J_SHAPES[shape])
    assert cell_applicable(get_config(arch), SHAPES[shape]) == want


def test_eight_skipped_cells():
    """long_500k on the 8 full-attention architectures (16 records over
    the two meshes)."""
    skips = [c for c in CELLS
             if cell_applicable(get_config(c[0]), SHAPES[c[1]])]
    assert len(skips) == 8
    assert {s for _, s in skips} == {"long_500k"}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs(arch, shape):
    ref = j_input_specs(j_get_config(arch), J_SHAPES[shape])
    port = input_specs(get_config(arch), SHAPES[shape])
    assert list(port) == list(ref)
    for k, spec in ref.items():
        t = port[k]
        assert t.is_meta, k
        assert tuple(t.shape) == tuple(spec.shape), k
        assert t.dtype == _torch_dtype(spec.dtype), k


def _bits(x) -> np.ndarray:
    """The raw bits of a jax array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        width = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}[x.element_size()]
        return x.view(width).numpy()
    arr = np.asarray(x)
    return arr.view({1: np.int8, 2: np.int16, 4: np.int32,
                     8: np.int64}[arr.dtype.itemsize])


# Small suites of each kind; the vision prefix needs more positions than
# its 256 image tokens.
SMALL = [("train", 260, 2), ("prefill", 264, 3), ("decode", 270, 2)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind,seq,batch", SMALL)
def test_sample_batch_bit_equal(arch, kind, seq, batch):
    name = f"small_{kind}"
    ref = j_sample_batch(j_get_config(arch),
                         JShapeSuite(name, seq, batch, kind), seed=7)
    port = sample_batch(get_config(arch), ShapeSuite(name, seq, batch, kind),
                        seed=7, device="cpu")
    assert list(port) == list(ref)
    for k in ref:
        assert port[k].device.type == "cpu"
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        assert port[k].dtype == _torch_dtype(ref[k].dtype), k
        np.testing.assert_array_equal(_bits(port[k]), _bits(ref[k]),
                                      err_msg=k)


def test_sample_batch_enc_out_is_bf16():
    """The encoder-decoder's decode input is drawn in the model's dtype."""
    cfg = get_config("seamless-m4t-large-v2")
    out = sample_batch(cfg, ShapeSuite("d", 16, 2, "decode"), device="cpu")
    assert out["enc_out"].dtype == torch.bfloat16
    assert out["pos"].shape == () and out["pos"].dtype == torch.int32


def test_sample_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        sample_batch(get_config("qwen3-0.6b"), ShapeSuite("d", 8, 1, "decode"))


def test_configs_exports():
    from repro_torch.configs import shapes
    assert tconfigs.SHAPES is shapes.SHAPES
    assert tconfigs.input_specs is shapes.input_specs
    assert tconfigs.shape_for is shapes.shape_for


# ---------------------------------------------------------------------------
# machine-model fields
# ---------------------------------------------------------------------------

def test_tpu_v5e_memory_and_dcn():
    assert tmachine.TPU_V5E.hbm_bytes == jmachine.TPU_V5E.hbm_bytes
    assert tmachine.TPU_V5E.dcn_bw == jmachine.TPU_V5E.dcn_bw


def test_h100_memory_and_dcn():
    h = tmachine.H100_SXM
    assert h.hbm_bytes == 80 * 1024**3
    assert h.dcn_bw == 50e9


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8",
                                   "float8_e4m3"])
@pytest.mark.parametrize("chips", [1, 4, 256])
def test_compute_seconds(dtype, chips):
    for flops in (1.0, 3.7e12, 6.02e18):
        assert tmachine.TPU_V5E.compute_seconds(flops, dtype, chips) == \
            jmachine.TPU_V5E.compute_seconds(flops, dtype, chips)
    h = tmachine.H100_SXM
    assert h.compute_seconds(2e15, dtype, chips) == \
        2e15 / (h.peak(dtype) * chips)


@pytest.mark.parametrize("chips", [1, 2, 512])
def test_memory_seconds(chips):
    for nbytes in (0.0, 512.0, 9.9e11):
        assert tmachine.TPU_V5E.memory_seconds(nbytes, chips) == \
            jmachine.TPU_V5E.memory_seconds(nbytes, chips)
    assert tmachine.H100_SXM.memory_seconds(3.35e12, chips) == 1.0 / chips


def test_compute_seconds_default_dtype_is_bf16():
    assert tmachine.TPU_V5E.compute_seconds(197e12) == 1.0
    assert jmachine.TPU_V5E.compute_seconds(197e12) == 1.0


def test_fingerprint_sees_the_new_fields():
    import dataclasses
    h = tmachine.H100_SXM
    assert dataclasses.replace(h, hbm_bytes=1).fingerprint != h.fingerprint
    assert dataclasses.replace(h, dcn_bw=1.0).fingerprint != h.fingerprint
    assert dataclasses.replace(h, dcn_bw=1.0).tuning_key == h.tuning_key
