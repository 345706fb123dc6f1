"""The RVQ: rave_tpu_torch.models.quantization against rave_tpu's, on the CPU.

Each test builds the JAX module and the port's at a tiny size (4-dimensional
vectors, codebook_size 16, 5 k-means iterations, 3 quantizers), loads the
JAX state into the port (`from_jax_variables`), and feeds both the same
numpy-seeded vectors. The JAX training call draws its k-means and expiry
sample rows from its rng (`randint(key)` and `randint(fold_in(key, 1))`,
quantizer i from `fold_in(rng, i)`); the test derives the same rows with
`jax.random` and hands them to the port. Two training calls in a row: the
first runs the k-means init, the second the EMA update with expiry.

Tolerances: code indices exactly equal; quantized vectors, the commitment
loss and the four state buffers (`embed`, `embed_avg`, `cluster_size`,
`inited`) at 1e-5 of the reference's largest magnitude (float32 sums of
up to 64 vectors in another order). The straight-through gradient at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.models import quantization as jq
from rave_tpu_torch.models import quantization as pq
from rave_tpu_torch.utils.convert import from_jax_variables

D, N, ITERS, Q = 4, 16, 5, 3
TOL = 1e-5
STATE = ("embed", "embed_avg", "cluster_size", "inited")


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def data(seed, shape=(2, 32, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def rows(key, P):
    """The JAX training call's (k-means, expiry) sample rows for its rng `key`."""
    return (np.asarray(jax.random.randint(key, (N,), 0, P)),
            np.asarray(jax.random.randint(jax.random.fold_in(key, 1), (N,), 0, P)))


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(autouse=True)
def few_kmeans_iters(monkeypatch):
    monkeypatch.setattr(pq.EuclideanCodebook, "KMEANS_ITERS", ITERS)


def assert_state(port_module, jax_tree, prefix=""):
    for name in STATE:
        got = port_module.get_buffer(prefix + name).numpy()
        assert rel_err(got, jax_tree[name]) <= TOL, (prefix + name, rel_err(got, jax_tree[name]))


@pytest.mark.parametrize("kmeans_init", [True, False], ids=["kmeans", "no-kmeans"])
def test_codebook_matches_jax(kmeans_init):
    """Init (or not: the JAX state loaded with `inited` 1), two training
    calls with expiry, then encode and decode."""
    jcb = jq.EuclideanCodebook(dim=D, codebook_size=N, kmeans_iters=ITERS,
                               kmeans_init=kmeans_init)
    x0 = data(0)
    variables = jcb.init({"params": jax.random.key(0)}, jnp.asarray(x0))
    pcb = pq.EuclideanCodebook(D, N)
    from_jax_variables(pcb, {"codebook": variables["codebook"]})
    assert pcb.needs_init() == kmeans_init
    expired = 0
    for call, seed in enumerate((1, 2)):
        x = data(seed) * (1 + call)  # the second batch spreads wider: codes fall idle
        key = jax.random.key(10 + call)
        (q_j, idx_j), upd = jcb.apply(variables, jnp.asarray(x), train=True, rng=key,
                                      mutable=["codebook"])
        variables = {**variables, **upd}
        init_idx, expire_idx = rows(key, x.shape[0] * x.shape[1])
        q_p, idx_p, state = pcb.train_call(t(x), t(init_idx), t(expire_idx))
        np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
        assert rel_err(q_p.numpy(), q_j) <= TOL
        pcb.commit(state)
        assert_state(pcb, upd["codebook"])
        assert not pcb.needs_init()
        expired += int((np.asarray(upd["codebook"]["cluster_size"]) < 2).sum())
    assert expired > 0  # the expiry branch replaced codes

    xe = data(3)
    idx_j = np.asarray(jcb.apply(variables, jnp.asarray(xe), method="encode"))
    np.testing.assert_array_equal(pcb.encode(t(xe)).numpy(), idx_j)
    dec_j = jcb.apply(variables, jnp.asarray(idx_j), method="decode")
    assert rel_err(pcb.decode(t(idx_j)).numpy(), dec_j) <= TOL
    (q_j, idx_j), _ = jcb.apply(variables, jnp.asarray(xe), mutable=["codebook"])
    q_p, idx_p = pcb(t(xe))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    assert rel_err(q_p.numpy(), q_j) <= TOL


def test_training_call_leaves_the_buffers_alone():
    pcb = pq.EuclideanCodebook(D, N)
    pcb.reset_parameters(torch.Generator().manual_seed(0))
    before = {k: pcb.get_buffer(k).clone() for k in STATE}
    idx = torch.arange(N)
    pcb.train_call(t(data(0)), idx, idx)
    assert all(torch.equal(pcb.get_buffer(k), before[k]) for k in STATE)
    assert pcb.needs_init()
    with torch.no_grad():  # a load writes the buffer: the flag is read again
        pcb.inited.fill_(1.0)
    assert not pcb.needs_init()


@pytest.fixture(scope="module")
def rvq_pair():
    jrvq = jq.ResidualVectorQuantization(num_quantizers=Q, dim=D, codebook_size=N,
                                         kmeans_iters=ITERS)
    variables = jrvq.init({"params": jax.random.key(0)}, jnp.asarray(data(0)))
    prvq = pq.ResidualVectorQuantization(Q, D, N)
    from_jax_variables(prvq, {"codebook": variables["codebook"]})
    return jrvq, variables, prvq


def test_rvq_stack_matches_jax(rvq_pair):
    """Two training calls of the 3-layer stack: quantized output, the summed
    commitment loss, indices [B, Q, T], each layer's state, and the
    gradient through the straight-through estimator and the loss."""
    jrvq, variables, prvq = rvq_pair
    w = data(9)
    for call, seed in enumerate((1, 2)):
        x = data(seed) * (1 + call)
        key = jax.random.key(20 + call)

        def loss_fn(xx, variables=variables, key=key):
            (q, loss, idx), upd = jrvq.apply(variables, xx, train=True, rng=key,
                                             mutable=["codebook"])
            return jnp.sum(q * w) + loss, (q, loss, idx, upd)

        (_, (q_j, loss_j, idx_j, upd)), g_j = jax.value_and_grad(loss_fn, has_aux=True)(
            jnp.asarray(x))
        variables = {**variables, **upd}
        P = x.shape[0] * x.shape[1]
        drawn = [rows(jax.random.fold_in(key, i), P) for i in range(Q)]
        init_idx = t(np.stack([d[0] for d in drawn]))
        expire_idx = t(np.stack([d[1] for d in drawn]))
        xp = t(x).requires_grad_()
        q_p, loss_p, idx_p, states = prvq(xp, init_idx, expire_idx, train=True)
        (torch.sum(q_p * t(w)) + loss_p).backward()
        assert idx_p.shape == (2, Q, 32)
        np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
        assert rel_err(q_p.detach().numpy(), q_j) <= TOL
        assert abs(float(loss_p.detach()) - float(loss_j)) <= TOL * abs(float(loss_j))
        assert rel_err(xp.grad.numpy(), g_j) <= TOL
        prvq.commit(states)
        for i in range(Q):
            assert_state(prvq, upd["codebook"][f"vq_{i}"]["codebook"], f"vq.{i}.codebook.")

    xe = jnp.asarray(data(3))
    (q_j, loss_j, idx_j), _ = jrvq.apply(variables, xe, mutable=["codebook"])
    q_p, loss_p, idx_p, states = prvq(t(xe))
    assert states is None and float(loss_p) == float(loss_j) == 0.0
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    assert rel_err(q_p.numpy(), q_j) <= TOL
    enc_j = np.asarray(jrvq.apply(variables, xe, method="encode"))
    np.testing.assert_array_equal(prvq.encode(t(xe)).numpy(), enc_j)
    dec_j = jrvq.apply(variables, jnp.asarray(enc_j), method="decode")
    assert rel_err(prvq.decode(t(enc_j)).numpy(), dec_j) <= TOL


def test_kmeans_and_nearest_match_jax():
    samples = data(4, (40, D))
    idx = np.random.default_rng(5).integers(0, 40, N)
    key = jax.random.key(6)
    means_j, bins_j = jq._kmeans(key, jnp.asarray(samples), N, ITERS)
    idx_j = np.asarray(jax.random.randint(key, (N,), 0, 40))
    means_p, bins_p = pq.kmeans(t(samples), N, ITERS, t(idx_j))
    assert rel_err(means_p.numpy(), means_j) <= TOL
    np.testing.assert_array_equal(bins_p.numpy(), np.asarray(bins_j))
    codes = samples[idx]  # duplicated rows: ties go to the first, in both
    state = {"embed": codes, "embed_avg": codes, "cluster_size": np.zeros(N, np.float32),
             "inited": np.float32(1.0)}
    want = jq.EuclideanCodebook(D, N).apply({"codebook": state}, jnp.asarray(samples),
                                            method="encode")
    np.testing.assert_array_equal(pq.nearest(t(samples), t(codes)).numpy(), np.asarray(want))
