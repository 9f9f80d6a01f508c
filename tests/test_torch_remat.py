"""ResNet(remat=True) in the port (torch.utils.checkpoint around each
bottleneck) against the JAX package's (nn.remat), as tests/test_remat.py
holds JAX's remat against its plain net: the same forward (1e-5) and the
same gradients (1e-4 relative, 1e-5 absolute), on bridged weights.

Element by element the comparison runs in float64 on both sides: in
float32 the CPU convolutions' backward sums in an order that changes from
run to run (torch's threads), which moves a near-zero gradient element of
the stem by ~1e-5 even between two runs of one net. In float32 the
gradients are held by norm (1e-4) against JAX's float64 ones, as
chip_smoke.py holds them on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from premvos_tpu.models.resnet import ResNet as JaxResNet
from premvos_tpu_torch import bridge
from premvos_tpu_torch.models.resnet import ResNet
from tests._threads import few_threads  # noqa: F401

@pytest.fixture(scope="module")
def case():
    """A ResNet-50 at 32×32: JAX's remat net in float64, initialised by
    flax, its loss (the sum of C5 squared) and gradients, and its weights
    bridged into the port's remat and plain nets in float64 and float32."""
    x = np.random.default_rng(16).standard_normal((1, 32, 32, 3))
    with jax.enable_x64(True):
        jnet = JaxResNet(depth=50, remat=True, dtype=jnp.float64)
        params = JaxResNet(depth=50).init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32))
        params = jax.tree.map(lambda a: a.astype(jnp.float64), params)
        loss = lambda q: jnp.sum(jnet.apply(q, jnp.asarray(x))["C5"] ** 2)  # noqa: E731
        value, grads = jax.jit(jax.value_and_grad(loss))(params)
        params, grads = jax.tree.map(np.asarray, (params, grads))
    nets = {}
    for name, dtype in (("float64", torch.float64), ("float32", torch.float32)):
        for remat in (True, False):
            net = ResNet(depth=50, remat=remat, dtype=dtype)
            bridge.load_flax_tree(net, params)
            nets[name, remat] = net
    return x, float(value), grads, nets


def _port_loss_and_grads(net, x):
    net.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    loss = (net(xt)["C5"] ** 2).sum()
    loss.backward()
    return loss.item(), {k: v.grad for k, v in net.named_parameters()}


def _by_norm(got, want):
    return float(torch.linalg.vector_norm(got.double() - want.double())
                 / torch.linalg.vector_norm(want.double()))


@pytest.mark.parametrize("remat", (True, False), ids=("remat", "plain"))
def test_port_resnet_matches_jax_remat(case, remat):
    """float64: the port's net (remat or not) against JAX's remat net, loss
    within 1e-5 relative, every parameter's gradient within 1e-4 relative
    and 1e-5 absolute of JAX's, in the port's layout."""
    x, want, jgrads, nets = case
    got, grads = _port_loss_and_grads(nets["float64", remat], x)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want_grads = bridge.flax_tensors(nets["float64", remat], jgrads)
    assert set(grads) <= set(want_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_float32_remat_matches_jax_by_norm(case):
    """float32: the port's remat net against JAX's (float64), loss within
    1e-5 relative, each gradient within 1e-4 of JAX's by norm."""
    x, want, jgrads, nets = case
    got, grads = _port_loss_and_grads(nets["float32", True], x.astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want_grads = bridge.flax_tensors(nets["float32", True], jgrads)
    worst = max(_by_norm(g, want_grads[k]) for k, g in grads.items())
    assert worst <= 1e-4, worst


def test_remat_changes_no_value_or_gradient(case):
    """float32, the port's remat net against its plain net on the same
    weights: loss within 1e-5, gradients within 1e-4 by norm; under
    no_grad the remat net runs its blocks directly, equal bit for bit."""
    x, _, _, nets = case
    x = x.astype(np.float32)
    a, ga = _port_loss_and_grads(nets["float32", True], x)
    b, gb = _port_loss_and_grads(nets["float32", False], x)
    np.testing.assert_allclose(a, b, rtol=1e-5)
    assert max(_by_norm(ga[k], gb[k]) for k in ga) <= 1e-4
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        plain = nets["float32", False](xt)
        for key, value in nets["float32", True](xt).items():
            assert torch.equal(value, plain[key]), key
