"""MLP classifier with an sklearn-``MLPClassifier``-like surface.

The reference uses ``sklearn.neural_network.MLPClassifier``
(classify.py:99). Here the network is plain JAX (a list of dense layers
as ``{"kernel", "bias"}`` dicts) trained with optax Adam — fit and
inference both run on device, and ``predict_proba`` is one batched
forward pass. Defaults mirror sklearn: hidden (100,), relu, adam,
learning_rate_init 1e-3, alpha (L2) 1e-4, max_iter 200, batch 200.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

_ACTIVATIONS = {
    "relu": jax.nn.relu,
    "tanh": jnp.tanh,
    "logistic": jax.nn.sigmoid,
    "identity": lambda x: x,
}


def _init_params(key, sizes: Sequence[int]):
    """Dense layers for ``sizes`` = (in, hidden..., out): LeCun-normal
    kernels (truncated at two standard deviations) and zero biases."""
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        key, sub = jax.random.split(key)
        # 0.8796 is the std of a unit normal truncated to [-2, 2]
        std = (1.0 / fan_in) ** 0.5 / 0.87962566
        w = jax.random.truncated_normal(sub, -2.0, 2.0, (fan_in, fan_out),
                                        jnp.float32) * std
        params.append({"kernel": w, "bias": jnp.zeros((fan_out,),
                                                      jnp.float32)})
    return params


def _forward(params, x, activation: str):
    act = _ACTIVATIONS[activation]
    for layer in params[:-1]:
        x = act(x @ layer["kernel"] + layer["bias"])
    return x @ params[-1]["kernel"] + params[-1]["bias"]


@functools.lru_cache(maxsize=32)
def _train_fns(hidden: Tuple[int, ...], activation: str, n_classes: int,
               alpha: float, lr: float):
    """(tx, jitted train_chunk) cached per hyperparameter set, so every
    fit with the same hyperparameters and shapes reuses one compiled
    program."""
    tx = optax.adam(lr)

    def train_epoch(params, opt_state, xb_stack, yb_stack, wb_stack,
                    nb_real):
        """One epoch: lax.scan over the minibatches (one device program
        instead of a dispatch per batch). The batch dim is BUCKETED so scenes with
        jittering object counts reuse one compiled program (VERDICT r3
        item 8): trailing all-pad batches (wb all zero) are exact no-ops
        via lax.cond — the L2 term alone would otherwise shrink the
        weights — and the epoch loss averages over the ``nb_real`` real
        batches only."""
        def step(carry, batch):
            params, opt_state = carry
            xb, yb, wb = batch

            def loss_fn(p):
                logits = _forward(p, xb, activation)
                n_real = jnp.maximum(wb.sum(), 1.0)
                # weighted mean: pad rows (wb=0) of the tail batch don't
                # pull the gradient
                ce = (optax.softmax_cross_entropy_with_integer_labels(
                    logits, yb) * wb).sum() / n_real
                # sklearn penalises only the weight matrices (coefs_),
                # never the biases
                l2 = sum(jnp.sum(w ** 2) for path, w in
                         jax.tree_util.tree_leaves_with_path(p)
                         if getattr(path[-1], "key", None) == "kernel") \
                    * (alpha / 2) / n_real
                return ce + l2

            def real_step(_):
                loss, grads = jax.value_and_grad(loss_fn)(params)
                updates, new_opt = tx.update(grads, opt_state)
                return optax.apply_updates(params, updates), new_opt, loss

            def pad_step(_):
                return params, opt_state, jnp.float32(0.0)

            new_params, new_opt, loss = jax.lax.cond(
                wb.any(), real_step, pad_step, operand=None)
            return (new_params, new_opt), loss

        (params, opt_state), losses = jax.lax.scan(
            step, (params, opt_state), (xb_stack, yb_stack, wb_stack))
        return params, opt_state, losses.sum() / nb_real

    @jax.jit
    def train_chunk(params, opt_state, xb_stack, yb_stack, wb_stack,
                    nb_real):
        """Several epochs per device call (outer scan over epochs, inner
        over minibatches): one dispatch and one loss download per chunk
        instead of per epoch."""
        def epoch(carry, batches):
            params, opt_state = carry
            params, opt_state, loss = train_epoch(params, opt_state,
                                                  *batches, nb_real)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            epoch, (params, opt_state), (xb_stack, yb_stack, wb_stack))
        return params, opt_state, losses

    return tx, train_chunk


_apply = jax.jit(_forward, static_argnames=("activation",))


_PREDICT_BUCKET = 4096
# minibatch-count bucket for the jitted fit: ceil(n/200) rounds up to a
# multiple of this so the per-chunk program shape is stable across scenes
_FIT_BATCH_BUCKET = 32


class FlaxMLPClassifier:
    """scikit-learn ``MLPClassifier``-like classifier in plain JAX + optax
    (the name predates the move off flax and is kept for callers)."""

    def __init__(self, hidden_layer_sizes=(100,), activation="relu",
                 alpha=1e-4, learning_rate_init=1e-3, max_iter=200,
                 batch_size="auto", random_state=0, tol=1e-4,
                 n_iter_no_change=10, **_ignored):
        self.hidden = tuple(int(h) for h in (
            hidden_layer_sizes if isinstance(hidden_layer_sizes, (tuple, list))
            else (hidden_layer_sizes,)))
        self.activation = activation
        self.alpha = float(alpha)
        self.lr = float(learning_rate_init)
        self.max_iter = int(max_iter)
        self.batch_size = batch_size
        self.random_state = int(random_state or 0)
        self.tol = float(tol)
        self.n_iter_no_change = int(n_iter_no_change)
        self._params = None
        self.classes_ = None

    def get_params(self):
        return {
            "hidden_layer_sizes": self.hidden, "activation": self.activation,
            "alpha": self.alpha, "learning_rate_init": self.lr,
            "max_iter": self.max_iter, "random_state": self.random_state,
        }

    def fit(self, X, y):
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        # deterministic-refit cache (same rationale as forest._FIT_CACHE:
        # the fit is seeded, so refitting an identical table is pure
        # recomputation on the scene critical path)
        from .forest import _FIT_CACHE, _FIT_CACHE_MAX, _fit_cache_key
        key = _fit_cache_key(
            {"mlp": True, "random_state": self.random_state,
             # every hyper-parameter the fit consumes must key the cache
             # (batch_size/tol/n_iter_no_change change the trained
             # weights but are not in the sklearn-facing get_params set)
             "batch_size": self.batch_size, "tol": self.tol,
             "n_iter_no_change": self.n_iter_no_change,
             **self.get_params()}, X, y)
        hit = _FIT_CACHE.get(key) if key is not None else None
        if hit is not None:
            self._params, self.classes_ = hit
            return self
        self._fit_impl(X, y)
        if key is not None:
            if len(_FIT_CACHE) >= _FIT_CACHE_MAX:
                _FIT_CACHE.pop(next(iter(_FIT_CACHE)))
            _FIT_CACHE[key] = (self._params, self.classes_)
        return self

    def _fit_impl(self, X, y):
        self.classes_, y_idx = np.unique(y, return_inverse=True)
        n_classes = len(self.classes_)
        n, f = X.shape
        tx, train_chunk = _train_fns(self.hidden, self.activation,
                                     n_classes, self.alpha, self.lr)
        params = _init_params(jax.random.PRNGKey(self.random_state),
                              (f,) + self.hidden + (n_classes,))
        bs = min(200, n) if self.batch_size == "auto" else min(
            int(self.batch_size), n)
        opt_state = tx.init(params)

        # every sample trains every epoch: a padded (weight-0) tail batch
        # covers the last n % bs rows instead of dropping them. The batch
        # COUNT and the table HEIGHT both bucket up so the jitted chunk
        # (and the on-disk compilation cache across processes) serves any
        # object count in the bucket — trailing all-pad batches are exact
        # no-op steps (see train_epoch), so the trained params are
        # bitwise-identical to the unbucketed fit.
        nb_real = -(-n // bs)
        nb = max(_FIT_BATCH_BUCKET,
                 -(-nb_real // _FIT_BATCH_BUCKET) * _FIT_BATCH_BUCKET)
        pad = nb * bs - n
        w_epoch = np.ones(nb * bs, np.float32)
        if pad:
            w_epoch[n:] = 0.0
        w_epoch = w_epoch.reshape(nb, bs)

        n_rows = max(_PREDICT_BUCKET,
                     -(-n // _PREDICT_BUCKET) * _PREDICT_BUCKET)
        X_pad = X if n_rows == n else np.concatenate(
            [X, np.zeros((n_rows - n, f), X.dtype)])
        Xd = jnp.asarray(X_pad)
        yd = jnp.asarray(np.concatenate(
            [y_idx, np.zeros(n_rows - n, y_idx.dtype)]) if n_rows != n
            else y_idx, jnp.int32)
        rng = np.random.default_rng(self.random_state)
        best = np.inf
        stale = 0
        chunk = max(1, min(self.n_iter_no_change, 10))
        epoch = 0
        while epoch < self.max_iter:
            ne = min(chunk, self.max_iter - epoch)
            perms = np.stack([
                np.concatenate([rng.permutation(n),
                                np.zeros(pad, np.int64)]).reshape(nb, bs)
                for _ in range(ne)])
            wb = jnp.asarray(np.broadcast_to(w_epoch, (ne, nb, bs)))
            params, opt_state, losses = train_chunk(
                params, opt_state, Xd[jnp.asarray(perms)],
                yd[jnp.asarray(perms)], wb, jnp.float32(nb_real))
            epoch += ne
            stop = False
            for epoch_loss in np.asarray(losses):
                # sklearn bookkeeping: stale increments when the epoch is
                # not better than best - tol, and best updates on ANY
                # improvement (not only improvements larger than tol)
                if epoch_loss > best - self.tol:
                    stale += 1
                    if stale >= self.n_iter_no_change:
                        stop = True
                else:
                    stale = 0
                if epoch_loss < best:
                    best = float(epoch_loss)
                if stop:
                    break
            if stop:
                # tol/stale bookkeeping replays per-epoch losses exactly;
                # the stop lands on a chunk boundary (a few extra epochs
                # of training vs the per-epoch loop — documented)
                break
        self._params = params
        return self

    def _logits(self, X):
        """Jitted forward over a ROW-BUCKETED batch: rows pad to the next
        _PREDICT_BUCKET multiple so scenes with jittering object counts
        reuse one compiled program (same rationale as forest predict)."""
        X = np.asarray(X, np.float32)
        n = X.shape[0]
        n_pad = max(_PREDICT_BUCKET,
                    -(-n // _PREDICT_BUCKET) * _PREDICT_BUCKET)
        if n_pad != n:
            X = np.concatenate(
                [X, np.zeros((n_pad - n, X.shape[1]), np.float32)])
        return jax.device_get(_apply(self._params, jnp.asarray(X),
                                     activation=self.activation))[:n]

    def predict_proba(self, X) -> np.ndarray:
        logits = self._logits(X)  # numpy; softmax on host (3 vector ops)
        z = logits - logits.max(axis=1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=1, keepdims=True)

    def predict(self, X) -> np.ndarray:
        proba = self.predict_proba(X)
        return self.classes_[np.argmax(proba, axis=1)]

    # -- checkpointing (reference has none — SURVEY.md §5) -------------------
    def save(self, path: str) -> None:
        import json
        import os
        from ..checkpoint import save_pytree
        # the pytree holds ARRAYS only (orbax cannot serialise strings);
        # every hyper-parameter the restored network depends on — loading
        # tanh-trained weights into a default relu graph would be silently
        # wrong — plus the (possibly string) class labels ride a JSON
        # sidecar
        save_pytree(path, {"params": self._params})
        meta = {"classes": np.asarray(self.classes_).tolist(),
                "hidden": list(self.hidden),
                "activation": self.activation,
                "alpha": self.alpha,
                "learning_rate_init": self.lr}
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)

    def load(self, path: str) -> "FlaxMLPClassifier":
        import json
        import os
        from ..checkpoint import load_pytree
        meta_path = path + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self.classes_ = np.asarray(meta["classes"])
            self.hidden = tuple(int(h) for h in meta["hidden"])
            self.activation = str(meta["activation"])
            self.alpha = float(meta["alpha"])
            self.lr = float(meta["learning_rate_init"])
            state = load_pytree(path)
        else:  # legacy layout: everything in the pytree
            state = load_pytree(path)
            self.classes_ = np.asarray(state["classes"])
            self.hidden = tuple(int(h) for h in np.asarray(state["hidden"]))
        self._params = [
            {k: jnp.asarray(v) for k, v in layer.items()}
            for layer in _layer_list(state["params"])]
        return self


def _layer_list(params):
    """Saved parameters as a list of layers. A pytree store may return a
    list as a dict keyed by position ("0", "1", ...)."""
    if isinstance(params, dict):
        return [params[k] for k in sorted(params, key=int)]
    return list(params)
