"""End-to-end driver: train a ~100M-parameter split LM with cascaded
hybrid VFL (the distilBERT experiment of paper §VI-D-c at framework
scale), on the card.

The client holds the token embedding (updated with ZOO, active-row mode);
the server holds the transformer stack (updated with FOO). Training goes
through ``repro_torch.launch.train.train`` (which wraps
``Federation.build(...).sync_step``), so any spelling from the method
alias table works and ``--dp-epsilon`` plugs a Gaussian DP channel into
the loss downlink. The PyTorch counterpart of ``examples/
train_lm_cascaded.py``: the same presets, arguments, printed lines and
check. Presets:

    ci    :  ~0.4M params,  60 steps  (seconds; used by CI)
    small :  ~20M params,  300 steps
    full  : ~100M params,  300 steps

    PYTHONPATH=src python examples_torch/train_lm_cascaded.py --preset small
    PYTHONPATH=src python examples_torch/train_lm_cascaded.py --device cpu
"""
import argparse
import json

from repro_torch.configs import ARCH_REGISTRY, ModelConfig
from repro_torch.core.methods import METHOD_ALIASES, canonical_method
from repro_torch.core.privacy import GaussianLossChannel
from repro_torch.device import resolve_device
from repro_torch.launch import train as train_mod

PRESETS = {
    "ci": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
               vocab_size=2048, steps=60, batch=8, seq=64),
    "small": dict(n_layers=6, d_model=384, n_heads=6, n_kv_heads=2,
                  d_ff=1536, vocab_size=16384, steps=300, batch=8, seq=128),
    "full": dict(n_layers=10, d_model=640, n_heads=10, n_kv_heads=2,
                 d_ff=2560, vocab_size=32000, steps=300, batch=8, seq=256),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="ci", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--method", default="cascaded",
                    choices=sorted(METHOD_ALIASES))
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--dp-epsilon", type=float, default=0.0,
                    help="per-release ε for the DP loss channel (0 = off)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    p = dict(PRESETS[args.preset])
    preset_steps = p.pop("steps")
    steps = args.steps or preset_steps
    batch, seq = p.pop("batch"), p.pop("seq")

    # register a bespoke config so the standard driver can train it
    cfg = ModelConfig(arch_id=f"lm-{args.preset}", family="dense",
                      act="swiglu", norm="rmsnorm", pos="rope", **p)
    ARCH_REGISTRY[cfg.arch_id] = cfg
    n_params = cfg.param_count()
    print(f"[e2e] {cfg.arch_id}: ~{n_params/1e6:.1f}M params, "
          f"{steps} steps, batch {batch}, seq {seq}")

    noise = (GaussianLossChannel(clip=10.0, epsilon=args.dp_epsilon)
             if args.dp_epsilon > 0 else None)
    res = train_mod.train(cfg.arch_id, steps=steps, batch=batch, seq=seq,
                          method=canonical_method(args.method), lr=0.05,
                          active_rows=True, use_reduced=False,
                          log_every=max(steps // 20, 1),
                          checkpoint_path=args.checkpoint, noise=noise,
                          device=dev)
    res["n_params"] = n_params
    print(json.dumps(res, indent=2))
    assert res["loss_last"] < res["loss_first"]
    return res


if __name__ == "__main__":
    main()
