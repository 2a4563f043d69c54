"""Direct label-inference attack demo (paper §VI-B, Table I), on the card.

Shows WHY the cascade keeps the wire gradient-free: against a FOO server
the curious client (and even a passive eavesdropper) reads labels off the
wire with certainty; against the ZOO wire both collapse to ~chance. The
PyTorch counterpart of ``examples/attack_demo.py``: the same attacks,
printed lines, and the draws of generators seeded 0 (label inference)
and 1 (feature inference), as the JAX example's keys are.

    PYTHONPATH=src python examples_torch/attack_demo.py
    PYTHONPATH=src python examples_torch/attack_demo.py --device cpu
"""
import argparse

from repro_torch.core import attacks
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    dev = resolve_device(ap.parse_args(argv).device)

    n = 2048
    print(f"{'framework':10s} {'curious client':>15s} {'eavesdropper':>15s}")
    results = {}
    for fw in ("foo", "zoo"):
        r = attacks.run_label_inference(10, n, framework=fw, seed=0,
                                        device=dev)
        results[fw] = r
        print(f"{fw:10s} {r.curious_client_acc:15.3f} "
              f"{r.eavesdropper_acc:15.3f}")
    print("\n(paper Table I: FOO 100/100, ZOO 11.7/10.0 — chance = 10%)")

    fr = attacks.run_feature_inference(seed=1, device=dev)
    print("\nfeature inference (§V-B, reconstruction MSE — lower = leak):")
    print(f"  with client-model access : {fr.mse_with_model_access:.3f}")
    print(f"  black-box (our protocol) : {fr.mse_black_box:.3f}")
    print(f"  chance (guess the mean)  : {fr.mse_chance:.3f}")
    # the outcome the demo shows: FOO leaks every label, ZOO about chance
    foo, zoo = results["foo"], results["zoo"]
    assert foo.curious_client_acc == 1.0 == foo.eavesdropper_acc
    assert zoo.curious_client_acc < 0.35
    assert abs(zoo.eavesdropper_acc - 0.10) < 0.05
    return results, fr


if __name__ == "__main__":
    main()
