"""``remat="dots"`` in every model family, held by the memory a training
forward pass keeps for its backward pass.

Remat changes no value (``test_torch_train.py::
test_remat_gives_the_same_grads``), so the gradients cannot tell a wrong
policy from a right one; the bytes held between the two passes can.  On
the JAX side they are ``saved_residuals`` of ``loss_fn`` (those that are
not arguments); on the port's, ``MetaPass``'s live bytes right after
``loss_fn`` on meta tensors (``live()``: storages the step made and still
holds).  Both at reduced widths, float32, tokens ``[2, 32]``, per layer
as 3 layers minus 2 (the parameters, the logits and the loss cancel).

The transformer (dense, MoE): ``"dots"`` minus ``"full"`` is the outputs
of the block's products without batch dimensions, as JAX saves them
under ``checkpoint_dots_with_no_batch_dims`` -- 98,304 B for qwen3 (q 64,
k 32, v 32, ``wo`` 64, gate 96, up 96 floats a token), 100,352 B for
moonshot (the router's 8 and one shared expert's gate and up in place of
the dense FFN's) -- plus one ``[B, S, d_model]`` float32 activation
(16,384 B): torch's selective checkpoint holds every saved product until
the block's recomputation, the FFN's down projection too, whose output
only the residual sum reads and which JAX drops
(``models/layers.py::remat_block``).  rwkv6, zamba2 and enc-dec run
``"dots"`` as ``"full"``, as JAX does: the same bytes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.meta import META, MetaPass  # noqa: E402
from repro_torch.models.layers import remat_block  # noqa: E402
from repro_torch.models.registry import build_model as t_build  # noqa: E402
from repro_torch.models.registry import make_batch, param_specs  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

B, S = 2, 32
# JAX's residual bytes a layer, "dots" minus "full" (saved_residuals on
# JAX 0.9.0, CPU)
JAX_DOTS_EXTRA = {"qwen3-1.7b": 98_304, "moonshot-v1-16b-a3b": 100_352}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from jax._src.ad_checkpoint import saved_residuals
    from repro.configs import get_config
    from repro.models.registry import build_model
    from repro.sharding import api as shard_api
    shard_api.deactivate()
    return dict(jax=jax, jnp=jnp, get_config=get_config,
                build_model=build_model, saved_residuals=saved_residuals)


def jax_held(jx, arch, remat, layers):
    """The non-argument residual bytes of the JAX ``loss_fn``."""
    cfg = dataclasses.replace(jx["get_config"](arch).reduced(), remat=remat,
                              num_layers=layers, scan_layers=False)
    model = jx["build_model"](cfg)
    params = model.init_params(jx["jax"].random.PRNGKey(0))
    tokens = jx["jnp"].zeros((B, S), jx["jnp"].int32)
    res = jx["saved_residuals"](
        lambda p: model.loss_fn(p, {"tokens": tokens, "labels": tokens}),
        params)
    return sum(a.size * a.dtype.itemsize for a, src in res
               if "argument" not in src)


def port_held(arch, remat, layers):
    """``MetaPass``'s live bytes right after the port's ``loss_fn`` on
    meta parameters that require grad (an enc-dec config ``layers`` deep
    in both stacks)."""
    base = t_get_config(arch).reduced()
    cfg = dataclasses.replace(
        base, remat=remat, num_layers=layers,
        num_decoder_layers=layers if base.num_decoder_layers else 0)
    params = param_specs(cfg)
    for _, t in tree_items(params):
        t.requires_grad_(True)
    g = torch.Generator().manual_seed(0)
    batch = {k: v.to(META) for k, v in make_batch(
        cfg, B, S, generator=g, device="cpu", train=True).items()}
    watch = MetaPass(exclude=(params, batch))
    with watch:
        loss = t_build(cfg).loss_fn(params, batch)
        held = watch.live()
    assert loss.requires_grad
    return held


def per_layer(held, arch, remat, layers=(2, 3)):
    a, b = (held(arch, remat, n) for n in layers)
    return b - a


@pytest.mark.parametrize("arch", sorted(JAX_DOTS_EXTRA))
def test_dots_holds_the_products_jax_saves(jx, arch):
    """The transformer's ``"dots"`` keeps, a layer, JAX's residuals under
    ``checkpoint_dots_with_no_batch_dims`` beyond ``"full"``, plus the
    block's last product (one float32 ``[B, S, d_model]``), and less than
    ``"none"``."""
    jax_extra = (per_layer(lambda *a: jax_held(jx, *a), arch, "dots")
                 - per_layer(lambda *a: jax_held(jx, *a), arch, "full"))
    assert jax_extra == JAX_DOTS_EXTRA[arch]
    port = {r: per_layer(port_held, arch, r) for r in ("none", "full",
                                                       "dots")}
    d_model = t_get_config(arch).reduced().d_model
    assert port["dots"] - port["full"] == jax_extra + 4 * B * S * d_model
    assert port["full"] < port["dots"] < port["none"]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_dots_holds_what_full_holds(arch):
    """rwkv6, zamba2 and enc-dec run ``"dots"`` as ``"full"``: the same
    bytes at every depth, below ``"none"``."""
    depths = (6, 12) if arch == "zamba2-7b" else (2, 3)
    for n in depths:
        assert port_held(arch, "dots", n) == port_held(arch, "full", n)
    assert (per_layer(port_held, arch, "dots", depths)
            < per_layer(port_held, arch, "none", depths))


@pytest.mark.parametrize("form,saved", [
    ("matmul", True), ("einsum", True), ("einsum-batch-1", True),
    ("bmm", False)])
def test_dots_policy_saves_unbatched_products(form, saved):
    """The policy's rule: a product without batch dimensions is saved,
    whether written ``x @ W`` (``aten.mm``) or as an einsum (``aten.bmm``
    of batch 1); a batched product (``aten.bmm`` of batch 2) is
    recomputed.  An einsum written with a batch axis of size 1 arrives as
    the same ``bmm`` of batch 1 and is saved too (the cost the rule
    states in ``layers.dots_policy``)."""
    x = torch.empty((B, S, 64), device=META, requires_grad=True)
    w = torch.empty((64, 96), device=META, requires_grad=True)
    w3 = torch.empty((B, 64, 96), device=META, requires_grad=True)
    fn = {"matmul": lambda x: (x @ w).tanh(),
          "einsum": lambda x: torch.einsum("bsd,de->bse", x, w).tanh(),
          "einsum-batch-1": lambda x: torch.einsum(
              "bsd,bde->bse", x[:1], w3[:1]).tanh(),
          "bmm": lambda x: torch.bmm(x, w3).tanh()}[form]

    def held(remat):
        watch = MetaPass(exclude=(x, w, w3))
        with watch:
            y = remat_block(remat, fn, x, save_products=True)
            n = watch.live()
        del y
        return n

    rows = 1 if form == "einsum-batch-1" else B
    assert held("dots") - held("full") == (4 * rows * S * 96 if saved
                                           else 0)


def test_dots_without_grad_runs_the_block_as_it_is():
    """Without grad nothing is checkpointed, so nothing is saved."""
    x = torch.empty((B, S, 64), device=META)
    w = torch.empty((64, 96), device=META)
    watch = MetaPass(exclude=(x, w))
    with watch, torch.no_grad():
        y = remat_block("dots", lambda x: x @ w, x, save_products=True)
        assert watch.live() == 4 * B * S * 96
    assert np.prod(y.shape) == B * S * 96
