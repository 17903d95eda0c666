"""braai real/bogus CNN in plain JAX — the ML scorer of the pipeline.

The reference loads the pretrained Keras ``braai_d6_m9`` (Duev et al. 2019,
VGG-6 architecture) and scores 63x63x3 new/ref/sub triplets one at a time
(``zuds/filterobjects.py:16-26,223-236``; the weights file ships outside the
repo). Here the same d6 architecture is a pure function of a params pytree,
scored in batches on device, with npz weight I/O and a full optax training
step (also exercised by the multi-chip dry run).

Every conv and dense product runs at ``Precision.HIGHEST``: an unpinned
float32 product runs in TF32 on the GPU, and the scores then differ from a
CPU float32 run of the same weights by far more than float32 rounding.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax

__all__ = ['BraaiD6', 'init_braai', 'load_braai', 'save_braai', 'rb_scores',
           'train_step', 'make_train_state', 'TRIPLET_SHAPE']

TRIPLET_SHAPE = (63, 63, 3)
_HI = jax.lax.Precision.HIGHEST


class BraaiD6:
    """VGG-6: 2x[conv-conv-pool-drop] + dense head, sigmoid output.

    Parameters live in a pytree ``{'params': {'Conv_0'..'Conv_3',
    'Dense_0', 'Dense_1'}}`` of ``{'kernel', 'bias'}`` leaves (HWIO conv
    kernels, (in, out) dense kernels) — the layout of the npz weight
    files.
    """

    features = (32, 64)
    dense = 256
    dropout_conv = 0.25
    dropout_dense = 0.5

    def init(self, key):
        """Lecun-normal kernels and zero biases, seeded by ``key``."""
        init = jax.nn.initializers.lecun_normal()
        shapes = []
        cin = TRIPLET_SHAPE[-1]
        for f in self.features:
            shapes += [(3, 3, cin, f), (3, 3, f, f)]
            cin = f
        side = TRIPLET_SHAPE[0]
        for _ in self.features:
            side = (side - 4) // 2
        dense_shapes = [(side * side * cin, self.dense), (self.dense, 1)]
        keys = jax.random.split(key, len(shapes) + len(dense_shapes))
        p = {}
        for i, s in enumerate(shapes):
            p[f'Conv_{i}'] = {'kernel': init(keys[i], s, jnp.float32),
                              'bias': jnp.zeros(s[-1], jnp.float32)}
        for i, s in enumerate(dense_shapes):
            p[f'Dense_{i}'] = {
                'kernel': init(keys[len(shapes) + i], s, jnp.float32),
                'bias': jnp.zeros(s[-1], jnp.float32)}
        return {'params': p}

    def apply(self, params, x, train=False, rng=None):
        """Scores in [0, 1] for (N, 63, 63, 3) triplets. ``train`` turns
        on dropout, which then needs ``rng``."""
        p = params['params']
        keys = (jax.random.split(rng, len(self.features) + 1) if train
                else [None] * (len(self.features) + 1))

        def dropout(x, rate, key):
            if not train:
                return x
            keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
            return jnp.where(keep, x / (1.0 - rate), 0.0)

        def conv(x, layer):
            y = jax.lax.conv_general_dilated(
                x, layer['kernel'], (1, 1), 'VALID',
                dimension_numbers=('NHWC', 'HWIO', 'NHWC'), precision=_HI)
            return jax.nn.relu(y + layer['bias'])

        for i in range(len(self.features)):
            x = conv(x, p[f'Conv_{2 * i}'])
            x = conv(x, p[f'Conv_{2 * i + 1}'])
            x = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max,
                                      (1, 2, 2, 1), (1, 2, 2, 1), 'VALID')
            x = dropout(x, self.dropout_conv, keys[i])
        x = x.reshape((x.shape[0], -1))
        x = jax.nn.relu(jnp.dot(x, p['Dense_0']['kernel'], precision=_HI)
                        + p['Dense_0']['bias'])
        x = dropout(x, self.dropout_dense, keys[-1])
        x = jnp.dot(x, p['Dense_1']['kernel'], precision=_HI) \
            + p['Dense_1']['bias']
        return jax.nn.sigmoid(x)[..., 0]


def init_braai(seed=0):
    model = BraaiD6()
    return model, model.init(jax.random.PRNGKey(seed))


def save_braai(params, path):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    arrays = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}
    np.savez(path, **arrays)


def load_braai(path=None, seed=0):
    """Model + params; pretrained npz if ``path`` given/exists, else
    fresh init (the reference's external-weights situation, documented)."""
    model, params = init_braai(seed)
    if path and os.path.exists(path):
        loaded = np.load(path)
        flat = jax.tree_util.tree_flatten_with_path(params)
        leaves = [jnp.asarray(loaded[jax.tree_util.keystr(k)])
                  for k, _ in flat[0]]
        params = jax.tree_util.tree_unflatten(flat[1], leaves)
    return model, params


@jax.jit
def rb_scores(params, triplets):
    """Batched real/bogus scores for (N, 63, 63, 3) L2-normalized triplets."""
    return BraaiD6().apply(params, triplets, train=False)


def make_train_state(seed=0, lr=3e-4):
    model, params = init_braai(seed)
    tx = optax.adam(lr)
    return model, params, tx, tx.init(params)


@jax.jit
def train_step(params, opt_state, triplets, labels, rng):
    """One BCE training step (adam)."""
    tx = optax.adam(3e-4)

    def loss_fn(p):
        scores = BraaiD6().apply(p, triplets, train=True, rng=rng)
        eps = 1e-7
        s = jnp.clip(scores, eps, 1 - eps)
        return -jnp.mean(labels * jnp.log(s) + (1 - labels) * jnp.log(1 - s))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = tx.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    return params, opt_state, loss
