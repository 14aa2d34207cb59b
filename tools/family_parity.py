"""How far the port's MoE, VLM, hybrid, xLSTM and enc-dec families sit from
the JAX reference on the CPU (smoke configs, the inputs of
``tests/test_torch_{moe,vlm,hybrid,xlstm,encdec}.py``): the largest logit
error through
prefill, verify, commit and decode (``test_torch_moe.logits_match``), and
each ``lm_loss`` grad leaf's largest error over the leaf's largest |g|.
``--float64`` runs the grads with float64 params in both packages (the
Mamba2 SSD still computes in fp32 in both, as written).  The sLSTM's
``bi`` grad is zero in exact arithmetic, so its ratio is rounding noise
over rounding noise.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/family_parity.py \\
        [--float64]

For the families whose reference verify hands an int8 pool over without
its scales (the hybrid, the enc-dec), it also prints each package's
largest logit error of a verify over an int8 pool against its float
verify (``test_torch_moe.int8_verify_gap``).

Prints one line per family and leaf, and a JSON line of the largest
errors last.  The tests hold these figures at their tolerances; this
prints them.
"""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

ARCHS = ("qwen3-moe-30b-a3b-smoke", "llava-next-mistral-7b-smoke",
         "zamba2-7b-smoke", "xlstm-125m-smoke", "seamless-m4t-medium-smoke")
INT8_ARCHS = ("zamba2-7b-smoke", "seamless-m4t-medium-smoke")


def grad_spread(arch, dtype):
    """{leaf path: max |port - JAX| / max |JAX|} of ``lm_loss``'s grads."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config
    from repro.models.api import get_model as j_get_model
    from repro.training import train as jtrain
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.data.pipeline import MarkovDataset
    from repro_torch.models.api import get_model as t_get_model
    from repro_torch.training import train as ttrain
    from test_torch_moe import family_batch
    from test_torch_training import _get, _jb, _paths
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(t_get_config(arch), dtype=dtype)
    jm, tm = j_get_model(cfg), t_get_model(tcfg)
    jp = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(0)))
    batch = next(iter(MarkovDataset(cfg.vocab_size, seed=1).batches(2, 16,
                                                                    1)))
    batch = family_batch(cfg, batch["tokens"]) | {"labels": batch["labels"]}
    (_, _), jg = jax.value_and_grad(
        lambda p: jtrain.lm_loss(cfg, jm, p, _jb(batch)), has_aux=True)(
            jax.tree.map(jnp.asarray, jp))
    _, tg = ttrain.lm_value_and_grad(
        tcfg, tm, params_from_jax(tcfg, jp, device="cpu"), batch)
    out = {}
    for path, g in _paths(jg):
        g = np.asarray(g, np.float64)
        t = _get(tg, path).double().numpy()
        out["/".join(map(str, path))] = float(np.max(np.abs(t - g))
                                    / max(np.max(np.abs(g)), 1e-30))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--float64", action="store_true")
    args = ap.parse_args(argv)
    import jax
    if args.float64:
        jax.config.update("jax_enable_x64", True)
    import torch
    torch.set_num_threads(1)
    from test_torch_moe import int8_verify_gap, logits_match
    summary = {}
    for arch in ARCHS:
        row = {}
        if not args.float64:
            row["logits"] = logits_match(arch)
            print(f"{arch}: largest logit error {row['logits']:.3e}")
            if arch in INT8_ARCHS:
                row["int8_verify"] = int8_verify_gap(arch)
                print(f"{arch}: int8-pool verify against the float verify: "
                      f"port {row['int8_verify']['port']:.3e}, reference "
                      f"{row['int8_verify']['reference']:.3e}")
        spread = grad_spread(arch, "float64" if args.float64 else "float32")
        for leaf, e in spread.items():
            print(f"{arch}: grad {leaf}: {e:.3e} x max|g|")
        row["grad"] = max(spread.values())
        summary[arch] = row
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
