"""The JAX package's all-to-all MoE on the cases of
tests/torch_moe_a2a_worker.py, for tests/test_torch_moe_a2a.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/jax_moe_a2a_ref.py INPUTS.npz OUT.npz

For each ("data", "model") mesh of the worker's (MESHES) and each case:
  * `moe_apply_a2a` under `shard_map` with every device's output kept
    (out spec over all devices): y, the local aux estimate and its pmean
    over data x model; the gradients of the mean over devices of sum(y^2)
    and of the mean over devices of the pmean'd aux, with respect to x and
    the weights (one global loss each);
  * the smoke-granite `loss_fn` (impl "a2a", capacity factor 8) under
    `with mesh:`: the loss and `jax.grad`, and whether its jaxpr holds an
    all_to_all (so the reference did not fall back to the dense path);
    one `make_train_step` step (AdamW defaults) under the mesh on the
    whole batch: new parameters, m, v, loss and grad norm.
Once, without a mesh: the same step of the dense smoke LM (smoke danube)
on the whole batch, the single-device step the port's data-parallel
step is held to.
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from repro.configs import granite_moe_3b, h2o_danube_1_8b  # noqa: E402
from repro.distributed.sharding import shard_map_compat  # noqa: E402
from repro.models import transformer as tf  # noqa: E402
from repro.models.moe import moe_apply_a2a  # noqa: E402
from repro.train.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro.train.train_loop import make_train_step  # noqa: E402

import torch_moe_a2a_worker as W  # noqa: E402


def make_mesh(shape) -> Mesh:
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))


def moe_case(mesh, shape, case, inputs, out):
    dp, ep = shape
    cfg = W.moe_config(case)
    every = P(("data", "model"), None, None)
    scal = P(("data", "model"))

    def fn(xl, router, w1, w3, w2):
        p = {"router": router, "w1": w1, "w3": w3, "w2": w2}
        y, aux = moe_apply_a2a(p, xl, cfg, ep=ep, axis_name="model")
        mean = jax.lax.pmean(aux, ("data", "model"))
        return y[None], aux[None], mean[None]

    run = shard_map_compat(
        fn, mesh=mesh,
        in_specs=(P("data", None), P(None, None), P("model", None, None),
                  P("model", None, None), P("model", None, None)),
        out_specs=(every, scal, scal), check_vma=False)
    n = dp * ep

    def loss_y(*a):
        return jnp.sum(run(*a)[0] ** 2) / n

    def loss_aux(*a):
        return jnp.sum(run(*a)[2]) / n

    def everything(*a):
        argn = tuple(range(5))
        return (run(*a), jax.grad(loss_y, argnums=argn)(*a),
                jax.grad(loss_aux, argnums=argn)(*a))

    args = [jnp.asarray(inputs[f"{case}/{k}"]) for k in W.LEAVES]
    (y, aux, mean), g_y, g_aux = jax.jit(everything)(*args)
    key = f"{dp}x{ep}/{case}"
    out[f"{key}/y"] = np.asarray(y)
    out[f"{key}/aux"] = np.asarray(aux)
    out[f"{key}/aux_mean"] = np.asarray(mean)
    for name, grads in (("y", g_y), ("aux", g_aux)):
        for leaf, g in zip(W.LEAVES, grads):
            out[f"{key}/grad_{name}/{leaf}"] = np.asarray(g)


def lm_case(mesh, shape, inputs, out):
    cfg = W.lm_config(granite_moe_3b)
    params = jax.tree.map(jnp.asarray, W.unflatten(inputs, "lm/params/"))
    batch = {"tokens": jnp.asarray(inputs["lm/tokens"])}

    def loss(p, b):
        return tf.loss_fn(p, b, cfg)

    with mesh:
        text = str(jax.make_jaxpr(loss)(params, batch))
        val, grads = jax.jit(jax.value_and_grad(loss))(params, batch)
    key = f"{shape[0]}x{shape[1]}/lm"
    out[f"{key}/loss"] = np.asarray(val)
    out[f"{key}/all_to_all"] = np.asarray("all_to_all" in text)
    for path, g in W._flat(grads):
        out[f"{key}/grad/{path}"] = np.asarray(g)
    with mesh:
        train_step(params, batch, cfg, f"{key}/train", out)


def train_step(params, batch, cfg, key, out):
    """One AdamW step (defaults, new arrays) on the whole batch."""
    opt_cfg = AdamWConfig()
    step = make_train_step(lambda p, b: tf.loss_fn(p, b, cfg), opt_cfg,
                           donate=False)
    new, opt, metrics = step(params, adamw_init(params, opt_cfg), batch)
    out[f"{key}/loss"] = np.asarray(metrics["loss"])
    out[f"{key}/grad_norm"] = np.asarray(metrics["grad_norm"])
    for name, tree in (("params", new), ("m", opt["m"]), ("v", opt["v"])):
        for path, leaf in W._flat(tree):
            out[f"{key}/{name}/{path}"] = np.asarray(leaf)


def main(inputs_path: str, out_path: str) -> int:
    assert len(jax.devices()) >= 8, jax.devices()
    inputs = dict(np.load(inputs_path))
    out = {}
    for shapes in W.MESHES.values():
        for shape in shapes:
            mesh = make_mesh(shape)
            for case in W.CASES:
                moe_case(mesh, shape, case, inputs, out)
            lm_case(mesh, shape, inputs, out)
    cfg = W.dense_config(h2o_danube_1_8b)
    train_step(jax.tree.map(jnp.asarray, W.unflatten(inputs, "dense/params/")),
               {"tokens": jnp.asarray(inputs["lm/tokens"])}, cfg,
               "dense/train", out)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
