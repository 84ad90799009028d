"""The selective-scan (Mamba-1) kernel, float32 arithmetic on the CUDA cores.

One launch: u, dt, z (B, D, L) and B, C (B, N, L) in bfloat16, A (D, N),
D and the dt bias (D,) and h0 (B, D, N) in float32 → y (B, L, D) bfloat16
and the last state (B, D, N) float32.  Operations, 2 a multiply-add: for
each (batch, channel, step, state) the state update h·dA + (dt·u)·B and
the read-out h·C (two multiply-adds) and the products dt·A and (dt·u)·B
(one each); the exponentials, the softplus, D·u and the gate are left out.
They run outside the tensor cores, so the bound takes the float32 peak.
Bytes: every input read once and both outputs written once."""
NAME = "selective_scan_kernel"


def cost(b: int, d: int, l: int, n: int):
    flops = 6 * b * d * l * n
    nbytes = (2 * 3 * b * d * l + 2 * 2 * b * n * l + 4 * (d * n + 2 * d + b * d * n)
              + 2 * b * l * d + 4 * b * d * n)
    return flops, nbytes
