"""Kernel B2's twin and the gouter conv against the JAX package, on the CPU.

- ``gouter_tap_dots_reference`` vs the Pallas kernel ``gouter_tap_dots_pallas``
  in interpret mode, at the shapes of ``tests/test_fastconv.py:365-369``
  (rtol = atol = 1e-5: the same f32 sums in another order);
- the autograd of ``nn/fastconv.py::gouter_tap_dots`` vs ``jax.grad`` of the
  JAX ``custom_vjp``, at the tolerances of ``test_fastconv.py:426-429``;
- ``fold_gouter``/``unfold_gouter``/``regroup_gouter`` (exact) and the
  gouter conv (values and gradients, 2e-5) vs ``fastconv.Conv(layout=
  "gouter")`` at the shapes of ``test_fastconv.py:228-237,276-285``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuraltexttospeech_torch.nn import fastconv as port_fc
from neuraltexttospeech_torch.ops import gouter_kernel
from neuraltexttospeech_tpu.nn import fastconv as jax_fc


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


@pytest.mark.parametrize("shape", [
    (4, 2, 32, 128, 128, 3, 1),
    (2, 2, 16, 256, 128, 4, 2),
])
def test_twin_matches_pallas_kernel(shape):
    from jax.experimental.pallas import tpu as pltpu

    from neuraltexttospeech_tpu.ops.gouter_kernel import gouter_tap_dots_pallas

    g, B, q, X, Y, kf, s = shape
    rng = np.random.default_rng(1)
    xp = rng.standard_normal((g, B, q + (kf - 1) * s, X)).astype(np.float32)
    wf = rng.standard_normal((kf, g, X, Y)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(gouter_tap_dots_pallas(jnp.asarray(xp), jnp.asarray(wf), s=s, q=q))
    before = gouter_kernel.gouter_tap_dots_kernel.launches
    got = gouter_kernel.gouter_tap_dots_kernel(_t(xp), _t(wf), s, q)
    assert gouter_kernel.gouter_tap_dots_kernel.launches == before  # CPU: the twin
    assert got.shape == want.shape == (g, B, q, Y)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [
    (2, 2, 16, 128, 128, 3, 2),  # test_fastconv.py:405
    (4, 3, 13, 32, 16, 5, 1),    # q not a multiple of 8
])
def test_autograd_matches_jax_custom_vjp(shape):
    g, B, q, X, Y, kf, s = shape
    rng = np.random.default_rng(2)
    qp = q + (kf - 1) * s
    xp = rng.standard_normal((g, B, qp, X)).astype(np.float32)
    wf = rng.standard_normal((kf, g, X, Y)).astype(np.float32)
    tgt = rng.standard_normal((g, B, q, Y)).astype(np.float32)

    def jax_loss(xp, wf):
        return jnp.mean(jnp.square(jax_fc.gouter_tap_dots(xp, wf, s, q) - tgt))

    gx_ref, gw_ref = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(wf))
    xt, wt = _t(xp).requires_grad_(), _t(wf).requires_grad_()
    torch.mean(torch.square(port_fc.gouter_tap_dots(xt, wt, s, q) - _t(tgt))).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cur_po,cur_g,pi,g", [
    (4, 4, 8, 16), (8, 16, 32, 16), (8, 16, 8, 16), (2, 16, 2, 16),
    (8, 16, 2, 16), (4, 8, 6, 8), (4, 16, 8, 4),
])
def test_regroup_gouter_matches_jax(cur_po, cur_g, pi, g):
    B, Q, co = 2, 12, 8
    x = np.random.default_rng(1).standard_normal((cur_g, B, Q, cur_po * co)).astype(np.float32)
    want = np.asarray(jax_fc.regroup_gouter(jnp.asarray(x), cur_po, cur_g, pi, g))
    got = port_fc.regroup_gouter(_t(x), cur_po, cur_g, pi, g).numpy()
    np.testing.assert_array_equal(got, want)
    back = port_fc.unfold_gouter(_t(x), cur_po, cur_g).numpy()
    np.testing.assert_array_equal(back, np.asarray(jax_fc.unfold_gouter(jnp.asarray(x),
                                                                          cur_po, cur_g)))
    np.testing.assert_array_equal(port_fc.fold_gouter(_t(back), cur_po, cur_g).numpy(), x)


@pytest.mark.parametrize("k,st,d,p,po", [(41, 2, 1, 8, 4), (41, 4, 1, 32, 8), (41, 1, 1, 2, 2),
                                         (5, 3, 1, 6, 2), (3, 1, 5, 4, 4)])
def test_plan_folded_matches_jax(k, st, d, p, po):
    want = jax_fc._plan_folded(k, st, d, p, po)
    got = port_fc.plan_folded(k, st, d, p, po)
    assert list(got[0]) == want[0] and got[1:] == tuple(want[1:])


@pytest.mark.parametrize("cout,k,s,g,pi", [
    (128, 41, 2, 4, 8), (256, 41, 2, 16, 16), (512, 41, 4, 16, 32), (1024, 41, 4, 16, 8),
    (1024, 41, 1, 16, 2), (64, 15, 1, 1, 4), (24, 5, 3, 2, 6),
])
def test_gouter_conv_matches_jax(cout, k, s, g, pi):
    """Values and grads (input, kernel, bias) of the port's gouter conv vs
    ``fastconv.Conv(layout="gouter")`` and stock ``nn.Conv``."""
    cin = cout if cout <= 128 else cout // 2
    B, L = 2, 4 * pi * s
    fc = jax_fc.Conv(cout, (k,), strides=(s,), feature_group_count=g, padding="SAME",
                     fold=pi, layout="gouter")
    ref = nn.Conv(cout, (k,), strides=(s,), feature_group_count=g, padding="SAME")
    key = jax.random.PRNGKey(6)
    x = jax.random.normal(key, (B, L, cin))
    params = ref.init(key, x)
    params = jax.tree_util.tree_map(  # a nonzero bias
        lambda a: a + 0.1 if a.ndim == 1 else a, params)
    want = np.asarray(fc.apply(params, jax_fc.fold_gouter(x, pi, g)))
    stock = np.asarray(ref.apply(params, x))

    def loss(prm, xx):
        return jnp.sum(jnp.sin(ref.apply(prm, xx)))

    g_prm, g_x = jax.grad(loss, argnums=(0, 1))(params, x)
    kernel = np.asarray(params["params"]["kernel"])
    w = _t(kernel.transpose(2, 1, 0)).requires_grad_()
    b = _t(params["params"]["bias"]).requires_grad_()
    xt = _t(x).requires_grad_()
    y = port_fc.gouter_conv(port_fc.fold_gouter(xt, pi, g), w, b, groups=g, stride=s, fold=pi)
    np.testing.assert_allclose(y.detach().numpy(), want, atol=2e-5, rtol=2e-5)
    plain = port_fc.unfold_gouter(y, pi // s, g)
    np.testing.assert_allclose(plain.detach().numpy(), stock, atol=2e-5, rtol=2e-5)
    torch.sum(torch.sin(plain)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(g_prm["params"]["kernel"])
                               .transpose(2, 1, 0), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(g_prm["params"]["bias"]),
                               atol=2e-5, rtol=2e-5)


def test_autograd_with_spare_rows_matches_plain_autograd():
    """Qp longer than the taps need (the JAX backward assumes it is not):
    the custom backward still equals autograd through the per-tap loop."""
    g, B, q, X, Y, kf, s = 2, 2, 9, 16, 8, 3, 2
    rng = np.random.default_rng(3)
    xp = _t(rng.standard_normal((g, B, q + (kf - 1) * s + 3, X)))
    wf = _t(rng.standard_normal((kf, g, X, Y)))
    dy = _t(rng.standard_normal((g, B, q, Y)))
    grads = []
    for fn in (port_fc.gouter_tap_dots, gouter_kernel.gouter_tap_dots_reference):
        x, w = xp.clone().requires_grad_(), wf.clone().requires_grad_()
        (fn(x, w, s, q) * dy).sum().backward()
        grads.append((x.grad, w.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_checks_shapes_only_on_cuda():
    """The CPU twin takes any shape; the checks the CUDA path applies refuse
    what the kernel does not take."""
    xp = torch.zeros(2, 1, 10, 64)
    wf = torch.zeros(3, 2, 64, 32)
    assert gouter_kernel.gouter_tap_dots_kernel(xp, wf, 1, 8).shape == (2, 1, 8, 32)
    ok_x, ok_w = torch.zeros(4, 2, 70, 128), torch.zeros(21, 4, 128, 256)
    gouter_kernel._check(ok_x, ok_w, 3, 10)
    bad = [
        (xp, wf, 1, 8),                                          # widths and groups
        (ok_x.double(), ok_w.double(), 3, 10),                   # dtype
        (ok_x, torch.zeros(22, 4, 128, 256), 3, 4),              # kf > 21
        (ok_x, ok_w, 3, 11),                                     # window past Qp
        (ok_x.transpose(2, 3), ok_w, 3, 10),                     # layout
        (torch.zeros(8, 2, 70, 128), torch.zeros(3, 8, 128, 128), 1, 8),  # g = 8
    ]
    for args in bad:
        with pytest.raises(ValueError):
            gouter_kernel._check(*args)
