"""The port's paged forward against the reference's, on the CPU.

Same weights (the reference's ``init_params`` bridged with
``bridge.params_from_jax``), same prompt, same page layout: the logits of
every chunked-prefill chunk (chunk sizes 1, 3 and 16) and of the decode
steps after it must agree in f32 to 2e-4 and in bf16 to 5e-2 -- on plain
GQA, on a config with qk_norm / post_norms / softcap / partial rotary /
tied embeddings, and on starcoder2-7b's smoke config (GELU, GQA).

The reference runs its paged-attention kernel in Pallas interpret mode, as
``paged_model.paged_impl()`` does on the CPU, once per config and dtype:
a one-shot prefill (one chunk holding the whole prompt) and a decode step.
Chunking does not change the math -- row i of any chunk attends to
positions <= i -- so the port's logits for every chunk size are held to
the rows of that one reference prefill, and its pages to the reference's.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import starcoder2_7b as j_sc2
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import dense_stack as j_stack
from repro.models import layers as jl
from repro.models.model import init_params as j_init
from repro.runtime.kv_store import PagedKVStore as JStore
from repro.serve import paged_model as jpm
from repro_torch.bridge import params_from_jax
from repro_torch.configs import starcoder2_7b as t_sc2
from repro_torch.configs.base import ArchConfig, dense_stack
from repro_torch.models import layers as tl
from repro_torch.runtime.kv_store import PagedKVStore
from repro_torch.serve import paged_model as tpm

PAGE = 4
PLAIN = dict(name="kv-plain", d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
             vocab=64, remat="none", dtype="float32")
FANCY = dict(name="kv-fancy", d_model=32, n_heads=4, n_kv_heads=4, d_ff=48,
             vocab=80, remat="none", dtype="float32", qk_norm=True,
             post_norms=True, attn_softcap=30.0, rope_pct=0.5,
             tie_embeddings=True)
CONFIGS = {
    "plain": (JArch(groups=j_stack(2), **PLAIN),
              ArchConfig(groups=dense_stack(2), **PLAIN)),
    "fancy": (JArch(groups=j_stack(3), **FANCY),
              ArchConfig(groups=dense_stack(3), **FANCY)),
    "sc2-smoke": (j_sc2.SMOKE, t_sc2.SMOKE),
}
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
PROMPT = [3, 1, 4, 1, 5, 9, 2]
BLOCKS = [5, 2, 7]                      # 12 slots: 7 prompt + decodes
FED = 6                                 # the token fed to the decode step


@functools.lru_cache(maxsize=None)
def _params(name):
    """Reference weights and their bridge (bf16 leaves whatever the
    config's compute dtype, so one draw serves both dtypes)."""
    jparams = j_init(CONFIGS[name][0], jax.random.PRNGKey(1))
    return jparams, params_from_jax(jax.device_get(jparams))


def _setup(name, dtype):
    jcfg, tcfg = CONFIGS[name]
    jcfg, tcfg = jcfg.scaled(dtype=dtype), tcfg.scaled(dtype=dtype)
    jparams, tparams = _params(name)
    jstore = JStore(jcfg, 8, PAGE, storage="device")
    tstore = PagedKVStore(tcfg, 8, PAGE, storage="device", device="cpu")
    return (jcfg, jparams, jstore), (tcfg, tparams, tstore)


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@functools.lru_cache(maxsize=None)
def _reference(name, dtype):
    """Reference prefill logits (one row per prompt position), the decode
    step after it, and the pages, in interpret mode."""
    jcfg, jparams, jstore = _setup(name, dtype)[0]
    (_, prefill), = jpm.prefill_kv_chunked(jparams, jcfg, jstore, BLOCKS,
                                           PROMPT, len(PROMPT),
                                           impl="interpret")
    decode = jpm.paged_decode_step(jparams, jcfg, jstore, [BLOCKS],
                                   [len(PROMPT)], [FED], impl="interpret")
    return (np.asarray(prefill, np.float32), np.asarray(decode, np.float32),
            np.asarray(jstore.k, np.float32), np.asarray(jstore.v, np.float32))


@pytest.mark.parametrize("chunk", [1, 3, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_chunked_prefill_and_decode_logits_match_reference(name, dtype,
                                                            chunk):
    """Every chunk's logits, the decode step that reads the chunked pages,
    and the pages after both, for chunk sizes 1, 3 and 16."""
    want_prefill, want_decode, want_k, want_v = _reference(name, dtype)
    tcfg, tparams, tstore = _setup(name, dtype)[1]
    ends, rows = [], []
    for end, logits in tpm.prefill_kv_chunked(tparams, tcfg, tstore, BLOCKS,
                                              PROMPT, chunk):
        ends.append(end)
        rows.append(logits)
    assert ends == list(range(chunk, len(PROMPT), chunk)) + [len(PROMPT)]
    _close(torch.cat(rows), want_prefill, dtype)
    decode = tpm.paged_decode_step(tparams, tcfg, tstore, [BLOCKS],
                                   [len(PROMPT)], [FED])
    _close(decode, want_decode, dtype)
    _close(tstore.k, want_k, dtype)
    _close(tstore.v, want_v, dtype)


@pytest.mark.parametrize("pct", [1.0, 0.5])
def test_layers_match_reference(pct):
    """The parity traps one by one: RMSNorm's ``1 + scale`` in f32, RoPE on
    interleaved pairs with partial rotary, tanh GELU, softcap, the MLP."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((3, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.asarray([0, 5, 17], np.int32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        tl.rms_norm(t(x), t(scale)).numpy(),
        np.asarray(jl.rms_norm(jax.numpy.asarray(x), jax.numpy.asarray(scale))),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tl.apply_rope(t(x), t(pos), 10000.0, pct).numpy(),
        np.asarray(jl.apply_rope(jax.numpy.asarray(x), jax.numpy.asarray(pos),
                                 10000.0, pct)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tl.activation("gelu")(t(x)).numpy(),
        np.asarray(jl.activation("gelu")(jax.numpy.asarray(x))),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tl.softcap(t(x) * 40, 30.0).numpy(),
        np.asarray(jl.softcap(jax.numpy.asarray(x) * 40, 30.0)),
        atol=1e-5, rtol=1e-5)
    w = {k: rng.standard_normal(sh).astype(np.float32) for k, sh in
         (("wi_gate", (16, 8)), ("wi_up", (16, 8)), ("wo", (8, 16)))}
    np.testing.assert_allclose(
        tl.mlp_apply({k: t(v) for k, v in w.items()}, t(x), "silu").numpy(),
        np.asarray(jl.mlp_apply({k: jax.numpy.asarray(v)
                                 for k, v in w.items()},
                                jax.numpy.asarray(x), "silu")),
        atol=1e-4, rtol=1e-4)


def test_prefill_chunk_must_be_positive():
    _, tside = _setup("plain", "float32")
    cfg, params, store = tside
    with pytest.raises(ValueError, match="chunk"):
        next(tpm.prefill_kv_chunked(params, cfg, store, BLOCKS, PROMPT, 0))
