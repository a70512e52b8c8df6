"""The port's serving driver (``repro_torch.launch.serve``) on the reduced
``qwen3-1.7b`` (and, for the dict it returns, every other arch it
serves): the loop and the dict it returns against the JAX package's
``serve``, greedy and sampled decoding, the cache size, and that the
``"kernel"`` attention route computes what the einsum routes compute (on
the CPU the kernel route takes the kernels' plain versions).

The ``cuda``-marked test drives ``serve`` on the card and counts the
kernels' launches; it imports no JAX:
``python -m pytest -m cuda tests/test_torch_serve.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models.registry import DECODE_SLACK  # noqa: E402

ARCH = "qwen3-1.7b"


@pytest.fixture
def jax_serve():
    """The JAX package's ``serve``, with any mesh a test before left active
    switched off (``launch/steps.py`` activates one and nothing deactivates
    it; the model's ``shard`` calls then fail)."""
    pytest.importorskip("jax")
    from repro.launch.serve import serve
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    return serve


def test_serve_dict_matches_jax(jax_serve):
    """Same keys, token shape and cache length as the JAX ``serve``."""
    kw = dict(batch=2, prompt_len=8, gen=3)
    want = jax_serve(ARCH, **kw)
    got = TS.serve(ARCH, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    assert got["tokens"].shape == want["tokens"].shape == (2, 4)
    assert got["cache_len"] == want["cache_len"] == 11
    assert got["tokens"].dtype == np.int32


@pytest.mark.parametrize("arch", ["llama3-8b", "internlm2-1.8b",
                                  "phi3-medium-14b", "moonshot-v1-16b-a3b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_zoo_serve_dict_matches_jax(jax_serve, arch):
    """The other dense configs and the MoE family serve through the same
    entry point, reduced on the CPU: the JAX ``serve``'s keys, token shape
    and cache length, tokens inside the real vocabulary."""
    kw = dict(batch=2, prompt_len=8, gen=3)
    want = jax_serve(arch, **kw)
    got = TS.serve(arch, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    assert got["tokens"].shape == want["tokens"].shape == (2, 4)
    assert got["cache_len"] == want["cache_len"] == 11
    assert 0 <= got["tokens"].min() and got["tokens"].max() < 512


@pytest.mark.parametrize("gen", [0, 1, 6])
def test_serve_shapes_and_times(gen):
    out = TS.serve(ARCH, batch=3, prompt_len=10, gen=gen, device="cpu")
    assert out["tokens"].shape == (3, gen + 1)
    assert out["cache_len"] == 10 + gen
    assert 0 <= out["tokens"].min() and out["tokens"].max() < 512
    assert out["prefill_s"] > 0
    if gen:
        assert 0 < out["decode_p50_ms"] <= out["decode_p95_ms"]
        assert out["tokens_per_s"] > 0


def test_prepare_sizes_the_cache_with_slack():
    model, params, batch, cache, _ = TS.prepare(
        ARCH, batch=2, prompt_len=16, gen=5, device="cpu")
    cfg = model.cfg
    assert cache.k.shape == (cfg.num_layers, 2, 16 + 5 + DECODE_SLACK,
                             cfg.num_kv_heads, cfg.head_dim)
    assert cache.length == 0
    assert batch["tokens"].shape == (2, 16)
    assert cfg.attention_impl == "chunked"       # the config's own on CPU
    assert params["embed"].shape == (cfg.padded_vocab, cfg.d_model)


def test_seeded_and_reproducible():
    a = TS.serve(ARCH, batch=2, prompt_len=8, gen=4, seed=3, device="cpu")
    b = TS.serve(ARCH, batch=2, prompt_len=8, gen=4, seed=3, device="cpu")
    c = TS.serve(ARCH, batch=2, prompt_len=8, gen=4, seed=4, device="cpu")
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_sampling_with_temperature():
    a = TS.serve(ARCH, batch=2, prompt_len=8, gen=6, temperature=1.0,
                 device="cpu")
    b = TS.serve(ARCH, batch=2, prompt_len=8, gen=6, temperature=1.0,
                 device="cpu")
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].max() < 512


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_attention_routes_agree(impl):
    """The same weights and prompt give the same greedy tokens and close
    logits through every attention route."""
    def run(impl):
        model, params, batch, cache, _ = TS.prepare(
            ARCH, batch=2, prompt_len=20, gen=6, attention_impl=impl,
            device="cpu")
        with torch.no_grad():
            logits, cache = model.prefill(params, batch, cache)
            steps = [logits]
            tok = logits[:, -1].argmax(-1, keepdim=True)
            for _ in range(6):
                logits, cache = model.decode_step(params, tok, cache)
                steps.append(logits)
                tok = logits[:, -1].argmax(-1, keepdim=True)
        return torch.cat(steps, 1)

    want, got = run("chunked"), run(impl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  want.argmax(-1).numpy())


def test_cpu_serve_launches_no_kernel():
    before = (FA.flash_attention.launches, DA.decode_attention.launches)
    model, params, batch, cache, _ = TS.prepare(
        ARCH, batch=1, prompt_len=4, gen=2, attention_impl="kernel",
        device="cpu")
    TS.generate(model, params, batch, cache, gen=2)
    assert (FA.flash_attention.launches,
            DA.decode_attention.launches) == before


def test_full_width_config_is_not_built_on_cpu_here():
    """The published widths: 28 layers, ~1.7 B parameters (counted from
    the shapes, nothing allocated)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import param_shapes
    cfg = get_config(ARCH)
    shapes = param_shapes(cfg)
    n = 0
    stack = [shapes]
    while stack:
        node = stack.pop()
        for v in node.values():
            if isinstance(v, dict):
                stack.append(v)
            else:
                n += int(np.prod(v))
    assert cfg.num_layers == 28 and cfg.padded_vocab == 152064
    assert 1.6e9 < n < 1.8e9, n


@pytest.mark.cuda
def test_cuda_serve_goes_through_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    FA.flash_attention.launches = DA.decode_attention.launches = 0
    out = TS.serve(ARCH, batch=2, prompt_len=40, gen=5)
    assert out["tokens"].shape == (2, 6) and out["cache_len"] == 45
    # reduced config: 2 layers, one flash launch per layer per prefill,
    # one decode launch per layer per step
    assert FA.flash_attention.launches == 2
    assert DA.decode_attention.launches == 2 * 5
