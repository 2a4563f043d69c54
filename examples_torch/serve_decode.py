"""Serve small models with batched requests across model families —
SPLIT inference through the Federation session's serve plane, on the
card: the client parties embed their token spans (whole spans in one
chunked-prefill upload), the server runs backbone + head with KV/SSM
caches, and every step's wire traffic (embedding up, token ids down)
lands in the session ledger. Covers KV-cache decode (granite MQA),
SSM-state decode (rwkv6) and hybrid decode (zamba2); whisper is
encoder-decoder — its modality frontend cannot cross the VFL wire, so it
exercises the global back-compat path. The granite run also drains the
same request load through the continuous-batching scheduler
(``fed.serve``) to show the churn path end to end. The PyTorch
counterpart of ``examples/serve_decode.py``: the same calls of
``repro_torch.launch.serve.serve``, printed lines and checks.

    PYTHONPATH=src python examples_torch/serve_decode.py
    PYTHONPATH=src python examples_torch/serve_decode.py --device cpu
"""
import argparse
import json

from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    dev = resolve_device(ap.parse_args(argv).device)

    out = []
    for arch in ("granite-20b", "rwkv6-7b", "zamba2-2.7b"):
        res = serve(arch, batch=4, prompt_len=12, gen_len=12,
                    temperature=0.8, n_clients=2, device=dev)
        print(json.dumps(res), flush=True)
        assert res["mode"] == "federated"
        assert res["wire_bytes"] > 0 and not res["wire_has_gradients"]
        out.append(res)
    # continuous batching: 4 requests through 2 slots, admissions
    # mid-flight, per-request exact wire
    res = serve("granite-20b", batch=4, prompt_len=12, gen_len=12,
                temperature=0.8, n_clients=2, continuous=True, max_batch=2,
                device=dev)
    print(json.dumps(res), flush=True)
    assert res["mode"] == "continuous" and res["slots"] == 2
    assert res["wire_bytes"] > 0 and not res["wire_has_gradients"]
    out.append(res)
    # enc-dec fallback: asked to split, served global with a reason
    res = serve("whisper-medium", batch=4, prompt_len=12, gen_len=12,
                temperature=0.8, n_clients=2, device=dev)
    print(json.dumps(res), flush=True)
    assert res["mode"] == "global" and "fallback" in res
    out.append(res)
    return out


if __name__ == "__main__":
    main()
