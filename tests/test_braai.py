"""Plain-JAX braai real/bogus CNN: shapes, weight I/O, training step."""
import numpy as np
import jax
import jax.numpy as jnp
import optax

from zuds_tpu.models.braai import (TRIPLET_SHAPE, BraaiD6, init_braai,
                                   load_braai, rb_scores, save_braai,
                                   train_step)


def _triplets(n, seed=0):
    t = np.random.default_rng(seed).normal(
        size=(n,) + TRIPLET_SHAPE).astype('f4')
    return t / np.linalg.norm(t.reshape(n, -1), axis=1)[:, None, None, None]


def test_forward_shape_and_range():
    _, params = init_braai(0)
    shapes = jax.tree_util.tree_map(lambda a: a.shape, params)['params']
    # the VGG-6 layout of the npz weight files
    assert shapes['Conv_0']['kernel'] == (3, 3, 3, 32)
    assert shapes['Conv_3']['kernel'] == (3, 3, 64, 64)
    assert shapes['Dense_0']['kernel'] == (12 * 12 * 64, 256)
    assert shapes['Dense_1']['kernel'] == (256, 1)
    s = np.asarray(rb_scores(params, jnp.asarray(_triplets(5))))
    assert s.shape == (5,)
    assert np.all((s > 0) & (s < 1))
    # seeded: the same seed gives the same weights, another seed does not
    _, again = init_braai(0)
    _, other = init_braai(1)
    k0 = np.asarray(params['params']['Conv_0']['kernel'])
    assert np.array_equal(k0, np.asarray(again['params']['Conv_0']['kernel']))
    assert not np.array_equal(k0,
                              np.asarray(other['params']['Conv_0']['kernel']))


def test_save_load_roundtrip(tmp_path):
    _, params = init_braai(3)
    path = str(tmp_path / 'braai.npz')
    save_braai(params, path)
    _, loaded = load_braai(path, seed=0)       # seed 0 differs from 3
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(loaded)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    trip = jnp.asarray(_triplets(4, seed=1))
    assert np.array_equal(np.asarray(rb_scores(params, trip)),
                          np.asarray(rb_scores(loaded, trip)))
    # no file: a fresh seeded init, not an error
    _, fresh = load_braai(str(tmp_path / 'missing.npz'), seed=3)
    assert np.array_equal(
        np.asarray(fresh['params']['Dense_1']['kernel']),
        np.asarray(params['params']['Dense_1']['kernel']))


def test_train_step_lowers_loss():
    _, params = init_braai(0)
    trip = jnp.asarray(_triplets(8, seed=2))
    labels = jnp.asarray(np.array([1, 0] * 4, 'f4'))

    def eval_loss(p):
        s = jnp.clip(BraaiD6().apply(p, trip), 1e-7, 1 - 1e-7)
        return float(-jnp.mean(labels * jnp.log(s)
                               + (1 - labels) * jnp.log(1 - s)))

    opt_state = optax.adam(3e-4).init(params)
    before = eval_loss(params)
    params, opt_state, loss = train_step(params, opt_state, trip, labels,
                                         jax.random.PRNGKey(0))
    assert np.isfinite(float(loss))
    assert eval_loss(params) < before


def test_dropout_only_in_training():
    _, params = init_braai(0)
    trip = jnp.asarray(_triplets(4, seed=4))
    model = BraaiD6()
    a = np.asarray(model.apply(params, trip))
    b = np.asarray(model.apply(params, trip))
    assert np.array_equal(a, b)
    t1 = np.asarray(model.apply(params, trip, train=True,
                                rng=jax.random.PRNGKey(1)))
    t2 = np.asarray(model.apply(params, trip, train=True,
                                rng=jax.random.PRNGKey(2)))
    assert not np.array_equal(t1, t2)
