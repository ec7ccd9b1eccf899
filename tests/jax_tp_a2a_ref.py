"""The JAX package's qwen3-smoke with 16 experts and the all-to-all MoE
(impl "a2a", the no-drop capacity factor of tests/torch_tp_worker.py)
under `with mesh:` on fake XLA host devices, for
tests/test_torch_tensor_parallel.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/jax_tp_a2a_ref.py IN.npz OUT.npz DPxTP [DPxTP ...]

IN.npz is the parity test's qwen3 case: the whole parameters flattened by
path under "p/", the batch under "b/tokens". For each ("data", "model")
mesh, under it: the loss and its gradient (`jax.value_and_grad` of
`loss_fn`), and one `make_train_step` step (AdamW at the worker's LR,
new arrays): the new parameters, m, v, the loss and the grad norm. Keys
"<dp>x<tp>/loss", "<dp>x<tp>/grad/<path>", "<dp>x<tp>/step/loss",
"<dp>x<tp>/step/grad_norm", "<dp>x<tp>/{params,m,v}/<path>". Each mesh's
jaxpr must hold an all_to_all (the reference did not fall back to the
dense path).
"""
import dataclasses
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import get as ref_get  # noqa: E402
from repro.models import transformer as tf  # noqa: E402
from repro.train.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro.train.train_loop import make_train_step  # noqa: E402

import torch_tp_worker as W  # noqa: E402


def a2a_config():
    cfg = ref_get("qwen3-moe-235b-a22b").smoke_config()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=16, impl="a2a",
        capacity_factor=W.A2A_NODROP_CF))


def run_mesh(shape, params, batch, cfg, out) -> None:
    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    key = f"{shape[0]}x{shape[1]}"

    def loss(p, b):
        return tf.loss_fn(p, b, cfg)
    opt_cfg = AdamWConfig(lr=W.LR)
    step = make_train_step(loss, opt_cfg, donate=False)
    with mesh:
        text = str(jax.make_jaxpr(loss)(params, batch))
        assert "all_to_all" in text, f"mesh {key}: no all_to_all"
        val, grads = jax.jit(jax.value_and_grad(loss))(params, batch)
        new, opt, metrics = step(params, adamw_init(params, opt_cfg), batch)
    out[f"{key}/loss"] = np.asarray(val)
    out[f"{key}/step/loss"] = np.asarray(metrics["loss"])
    out[f"{key}/step/grad_norm"] = np.asarray(metrics["grad_norm"])
    for name, tree in (("grad", grads), ("params", new), ("m", opt["m"]),
                       ("v", opt["v"])):
        for path, leaf in W.flatten(jax.tree.map(np.asarray, tree)).items():
            out[f"{key}/{name}/{path}"] = leaf


def main(in_path: str, out_path: str, shapes: list) -> int:
    with np.load(in_path) as z:
        flat = {k: z[k] for k in z.files}
    params = jax.tree.map(jnp.asarray, W.unflatten(
        {k[2:]: v for k, v in flat.items() if k.startswith("p/")}))
    batch = {"tokens": jnp.asarray(flat["b/tokens"])}
    cfg = a2a_config()
    out = {}
    for shape in shapes:
        run_mesh(shape, params, batch, cfg, out)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2],
                  [tuple(int(x) for x in s.split("x"))
                   for s in sys.argv[3:]]))
