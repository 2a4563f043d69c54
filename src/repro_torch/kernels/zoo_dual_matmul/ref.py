"""Plain PyTorch versions of the fused dual matmul: the CPU path of
``ops.py`` and the oracle the CUDA kernel is held against on the card.

Every function takes optional leading batch dims (the engine's client
block axis), computes in f32 and returns x's dtype."""
import torch


def zoo_dual_matmul_ref(x, w, u, mu):
    xf, wf = x.float(), w.float()
    y = xf @ wf
    y_hat = xf @ (wf + mu * u.float())
    return y.to(x.dtype), y_hat.to(x.dtype)


def zoo_dual_matmul_stacked_ref(x, w, us, mu):
    """x (..., M, K), w (..., K, N), us (..., q, K, N) ->
    (y (..., M, N), y_hat (..., q, M, N))."""
    xf = x.float()
    y = xf @ w.float()
    yu = xf.unsqueeze(-3) @ us.float()
    return y.to(x.dtype), (y.unsqueeze(-3) + mu * yu).to(x.dtype)


def zoo_dual_matmul_stacked_bias_relu_ref(x, w, us, b, ub, mu):
    """Unfused bias+ReLU epilogue: y = relu(xW + b),
    ŷ_l = relu(x(W + μU_l) + b + μu_b_l); b (..., N), ub (..., q, N)."""
    y, y_hat = zoo_dual_matmul_stacked_ref(x, w, us, mu)
    bf = b.float().unsqueeze(-2)                              # (..., 1, N)
    clean = torch.relu(y.float() + bf)
    pert = torch.relu(y_hat.float()
                      + (bf + mu * ub.float()).unsqueeze(-2))
    return clean.to(x.dtype), pert.to(x.dtype)
