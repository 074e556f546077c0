"""Times ``repro_torch.models.common.silu`` (op by op forward, a hand
backward: ``_Silu``) against the same ops differentiated by autograd,
forward plus backward in bf16 at llama3.2-3b's and mixtral-8x7b's FFN
widths ([4096, 8192], [4096, 14336]), in turns (autograd, hand, hand,
autograd; CUDA events, 50 calls each), on one card:

    PYTHONPATH=src python scripts/torch_port_silu_ab.py

Also prints whether the forwards are bitwise equal and the largest
difference of the gradients.
"""

import torch

from repro_torch.models.common import silu


def autograd_silu(x):
    return x * (1 / (1 + torch.exp(-x)))


def timed(fn, x, g, n=50):
    for _ in range(5):
        fn(x).backward(g)
        x.grad = None
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn(x).backward(g)
        x.grad = None
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def main():
    for shape in ((4096, 8192), (4096, 14336)):
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16).requires_grad_()
        g = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
        rows = [(name, timed(fn, x, g)) for name, fn in
                (("autograd", autograd_silu), ("hand", silu), ("hand", silu),
                 ("autograd", autograd_silu))]
        a, b = x.detach().clone().requires_grad_(), x.detach().clone().requires_grad_()
        ya, yb = autograd_silu(a), silu(b)
        ya.backward(g)
        yb.backward(g)
        print(f"[silu_ab] shape={shape} ms={rows} forward_bitwise={torch.equal(ya, yb)} "
              f"grad_max_abs_diff={(a.grad.float() - b.grad.float()).abs().max().item()} "
              f"card={torch.cuda.get_device_name(0)}", flush=True)


if __name__ == "__main__":
    main()
