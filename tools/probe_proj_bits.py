"""Whether the library's batched GEMM gives a layer of a band the bits it
gets alone, for the Mamba mixer's four projections at jamba-1.5-large's
and falcon-mamba-7b's widths.

The mamba cells run a band's projections as ``torch.matmul`` over ``[G,
rows, K] @ [G, K, N]``; the diagonal schedule equals the sequential one
to the bit only if group 0's output at G = 2 is its output at G = 1 (the
sequential schedule's call). For each projection and row count (1,024,
1,152: B = 1 with and without the memory tokens; 2,304: B = 2) it prints
whether G = 2's group 0 equals G = 1, and whether G = 1 equals the 2-D
call, on random bf16 operands.

    python3 tools/probe_proj_bits.py        # on a CUDA card
"""
import torch


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*s):
        return (torch.randn(*s, generator=g, device=dev) * 0.05).to(torch.bfloat16)

    def same(a, b):
        return torch.equal(a.view(torch.int16), b.view(torch.int16))

    for name, D, dI, dtr, dS in (("jamba", 8192, 16384, 512, 16),
                                 ("falcon", 4096, 8192, 256, 16)):
        for M in (1152, 2304, 1024):
            for pname, K, N in (("in_proj", D, 2 * dI), ("x_proj", dI, dtr + 2 * dS),
                                ("dt_proj", dtr, dI), ("out_proj", dI, D)):
                x, w = rnd(2, M, K), rnd(2, K, N)
                both, one = torch.matmul(x, w), torch.matmul(x[:1], w[:1])
                print(f"{name} M={M} {pname} [{K}x{N}]: G=2 group0 == G=1: "
                      f"{same(both[0], one[0])}; G=1 == 2-D: "
                      f"{same(one[0], torch.matmul(x[0], w[0]))}", flush=True)


if __name__ == "__main__":
    main()
