"""The tensor-parallel collectives of ``distributed.collectives`` in four
gloo ranks on the CPU (one model group of 4), against the same function
in one process:

  * a replicated loss through a column-split then row-split MLP
    (``enter_split``, ``leave_split``), through per-head blocks gathered
    back (``split_of``, ``gather_split``) and through a sequence-parallel
    block (``seq_gather``, ``seq_scatter``) gives every rank the
    one-process loss and the gradient of its blocks (and the whole
    gradient of a replicated input) within 1e-6 relative, in f32;
  * the trap: with ``all_sum`` in place of ``leave_split``, or
    ``gather_dim`` in place of ``gather_split``, the same loss's
    gradients come out 4 times the one-process ones (their backward sums
    over the group a cotangent every rank computes alike);
  * with grad mode off each returns its forward.
"""
import textwrap

import torch

from test_torch_dp_train import _run_ranks

REL = 1e-6

RANK = textwrap.dedent("""
    import sys, torch
    torch.set_num_threads(1)
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import init_distributed, make_mesh
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_distributed(rank, world, f"{tmp}/rdv", device="cpu")
    mesh = make_mesh((world,), ("model",))
    g = mesh.get_group("model")
    inp = torch.load(f"{tmp}/inputs.pt")
    n = world

    def mlp(exit_fn):
        x = inp["x"].clone().requires_grad_(True)
        w1 = torch.chunk(inp["w1"], n, 1)[rank].clone().requires_grad_(True)
        w2 = torch.chunk(inp["w2"], n, 0)[rank].clone().requires_grad_(True)
        h = torch.tanh(C.enter_split(x, g) @ w1)
        y = exit_fn(h @ w2, g)
        loss = torch.sum(y * inp["r"])
        return [loss.detach()] + list(torch.autograd.grad(loss, [x, w1, w2]))

    def heads(gather):
        e = inp["e"].clone().requires_grad_(True)          # (B, H, d)
        w = torch.chunk(inp["wh"], n, 0)[rank].clone().requires_grad_(True)
        y = torch.einsum("bhd,hdk->bhk", C.split_of(e, 1, g), w)
        y = gather(torch.tanh(y), 1, g)
        loss = torch.sum(y * inp["rh"])
        return [loss.detach()] + list(torch.autograd.grad(loss, [e, w]))

    def seq():
        xs = torch.chunk(inp["xs"], n, 1)[rank].clone().requires_grad_(True)
        w1 = torch.chunk(inp["w1"], n, 1)[rank].clone().requires_grad_(True)
        w2 = torch.chunk(inp["w2"], n, 0)[rank].clone().requires_grad_(True)
        h = torch.tanh(C.seq_gather(xs, 1, g) @ w1)
        y = C.seq_scatter(h @ w2, 1, g)
        part = torch.sum(y * torch.chunk(inp["rs"], n, 1)[rank])
        loss = C.leave_split(part, g)
        return [loss.detach()] + list(torch.autograd.grad(loss, [xs, w1, w2]))

    with torch.no_grad():
        x, e = inp["x"], inp["e"]
        plain = dict(enter=C.enter_split(x, g) is x,
                     leave=torch.equal(C.leave_split(x, g), x * n),
                     gather=torch.equal(C.gather_split(
                         torch.chunk(e, n, 1)[rank], 1, g), e),
                     split=torch.equal(C.split_of(e, 1, g),
                                       torch.chunk(e, n, 1)[rank]))
    torch.save(dict(mlp=mlp(C.leave_split), mlp_all_sum=mlp(C.all_sum),
                    heads=heads(C.gather_split),
                    heads_gather_dim=heads(C.gather_dim), seq=seq(),
                    plain=plain), f"{tmp}/rank{rank}.pt")
    torch.distributed.barrier()     # no rank tears down mid-exchange
    torch.distributed.destroy_process_group()
""")


def _rel(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def test_tensor_parallel_pair_and_the_trap(tmp_path):
    n, B, S, d, f, H, k = 4, 3, 8, 6, 16, 4, 5
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32)
    inp = dict(x=rnd(B, d), w1=rnd(d, f), w2=rnd(f, d), r=rnd(B, d),
               e=rnd(B, H, d), wh=rnd(H, d, k), rh=rnd(B, H, k),
               xs=rnd(B, S, d), rs=rnd(B, S, d))
    torch.save(inp, tmp_path / "inputs.pt")
    _run_ranks(RANK, n, tmp_path, timeout=120.0)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(n)]

    # one process
    def grads(fn, *leaves):
        leaves = [t.clone().requires_grad_(True) for t in leaves]
        loss = fn(*leaves)
        return [loss.detach()] + list(torch.autograd.grad(loss, leaves))
    want = {
        "mlp": grads(lambda x, w1, w2: torch.sum(
            (torch.tanh(x @ w1) @ w2) * inp["r"]),
            inp["x"], inp["w1"], inp["w2"]),
        "heads": grads(lambda e, w: torch.sum(torch.tanh(torch.einsum(
            "bhd,hdk->bhk", e, w)) * inp["rh"]), inp["e"], inp["wh"]),
        "seq": grads(lambda x, w1, w2: torch.sum(
            (torch.tanh(x @ w1) @ w2) * inp["rs"]),
            inp["xs"], inp["w1"], inp["w2"])}
    # each rank's block of each gradient: (dim, split) per leaf
    blocks = {"mlp": (None, None, 1, 0), "heads": (None, None, 0),
              "seq": (None, 1, 1, 0)}
    for r, got in enumerate(ranks):
        assert all(got["plain"].values()), (r, got["plain"])
        for case, dims in blocks.items():
            for i, (g, w, dim) in enumerate(zip(got[case], want[case],
                                                dims)):
                if dim is not None:
                    w = torch.chunk(w, n, dim)[r]
                assert _rel(g, w) <= REL, (case, r, i, _rel(g, w))
        # the trap: the gradients n times the one-process ones
        for case, base in (("mlp_all_sum", "mlp"),
                           ("heads_gather_dim", "heads")):
            assert _rel(got[case][0], want[base][0]) <= REL
            for i, dim in enumerate(blocks[base][1:], start=1):
                w = want[base][i]
                if dim is not None:
                    w = torch.chunk(w, n, dim)[r]
                assert _rel(got[case][i], n * w) <= REL, (case, r, i)
