"""The multi-process training CLI and the one-process behaviour of the
``parallel/`` modules.

``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
visualrwkv_torch.train.cli --dummy --device cpu`` with ``--n_data 2`` and with
``--n_seq 2`` (gloo; torchrun's rendezvous on a free local port) takes its 4
steps as the one-process run on the same rows does (``--accumulate_grad_batches
2`` for the 2 data ranks' rows): the 4 logged losses agree to their printed
decimals, and rank 0 writes one checkpoint of the 4 steps. (The parameters
are held element by element in ``test_torch_parallel_data.py``: the dummy
run starts from the reference's init, whose zero projections get gradients
near 0 whose sign is rounding, and Adam's first steps move such an element
by about the learning rate either way.) Without a process group the helpers
answer for one process; the ZeRO rule is the JAX package's."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (caps torch's CPU threads)
from visualrwkv_torch.parallel import collectives, distributed, mesh
from visualrwkv_torch.train import cli as pcli
from visualrwkv_torch.train.optim import tree_leaves_with_path
from visualrwkv_tpu.parallel.mesh import _shardable_axis as j_shardable_axis

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
FLAGS = ["--dummy", "--device", "cpu", "--vocab_size", "1024"]
CASES = {"n_data": (["--n_data", "2"], ["--accumulate_grad_batches", "2"]),
         "n_seq": (["--n_seq", "2"], [])}


@pytest.fixture(scope="module")
def torchrun(tmp_path_factory):
    """Both 2-process runs, started together, and the one-process runs made
    while they work: {case: (returncode, log, checkpoint, one-process trainer)}."""
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                                            "WORLD_SIZE", "LOCAL_RANK")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    runs = {}
    for case, (flags, _) in CASES.items():
        out = tmp_path_factory.mktemp(f"torchrun_{case}")
        log = open(out / "log.txt", "w")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
               "-m", "visualrwkv_torch.train.cli", *FLAGS, "--proj_dir", str(out), *flags]
        runs[case] = (subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT),
                      out, log)
    one = {case: pcli.main(FLAGS + ["--proj_dir", str(tmp_path_factory.mktemp(f"one_{case}"))] + extra)
           for case, (_, extra) in CASES.items()}
    results = {}
    for case, (proc, out, log) in runs.items():
        try:
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        results[case] = (proc.returncode, (out / "log.txt").read_text(), out / "rwkv-0.pth", one[case])
    return results


@pytest.mark.parametrize("case", list(CASES))
def test_torchrun_cli_runs_two_processes(torchrun, case):
    rc, log, ckpt, one = torchrun[case]
    assert rc == 0, log[-4000:]
    assert {"n_data": "x data 2 x", "n_seq": "), seq 2"}[case] in log
    saved = torch.load(ckpt, weights_only=True)
    assert saved["step"] == 4 and saved["opt_state"]["count"] == 4
    logged = [float(line.split(" loss ")[1].split()[0]) for line in log.splitlines() if "/4 loss " in line]
    np.testing.assert_allclose(logged, [h["loss"] for h in one.history], rtol=0, atol=1.5e-4)
    assert len(logged) == 4
    shapes = {path: tuple(t.shape) for path, t in tree_leaves_with_path(one.params)}
    for path, t in tree_leaves_with_path(saved["params"]):
        assert tuple(t.shape) == shapes[path] and torch.isfinite(t).all(), path
    # rank 0 alone writes the run log and logs the steps
    lines = (ckpt.parent / "train_log.txt").read_text().splitlines()
    assert sum(line.startswith("NEW RUN") for line in lines) == 1
    assert log.count("step 3/4") == 1


def test_one_process_without_a_group():
    """No address and no process count: the no-op start (False), the
    one-process mesh (None), sizes 1 and the batch as it is; a mesh larger
    than the group, or a model axis, raises."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", distributed.ENV_COORDINATOR,
              distributed.ENV_NUM_PROCESSES, distributed.ENV_PROCESS_ID):
        assert k not in os.environ
    assert distributed.initialize(device="cpu") is False
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert distributed.local_batch_size(8) == 8
    assert mesh.make_mesh() is None and mesh.make_mesh(n_data=1, n_seq=1) is None
    assert [mesh.axis_size(None, a) for a in mesh.AXES] == [1, 1, 1]
    assert mesh.axis_index(None, "seq") == 0 and mesh.axis_group(None, "data") is None
    with pytest.raises(ValueError):
        mesh.make_mesh(n_data=2)
    with pytest.raises(ValueError):
        mesh.make_mesh(n_model=2)
    with pytest.raises(ValueError):
        distributed.initialize(num_processes=2, device="cpu")
    batch = {"input_ids": np.zeros((4, 8)), "images": {"dino": np.zeros((4, 2, 2, 3))}}
    assert mesh.local_batch(batch, None) is batch


def test_zero_rule_matches_jax():
    """``shardable_axis`` picks the leaf dim JAX's ``_shardable_axis`` picks,
    over shapes below, at and above the 2^16 floor, divisible or not."""
    shapes = [(65536,), (65535,), (256, 256), (255, 257), (3, 65536), (2048, 2048), (1, 1, 70000),
              (65536, 3), (7, 10000), (4, 16384)]
    for shape in shapes:
        for n in (1, 2, 3, 4, 8):
            assert mesh.shardable_axis(shape, n) == j_shardable_axis(shape, n, 2**16), (shape, n)
    tree = {"a": torch.zeros(512, 128), "b": [torch.zeros(4)], "c": None}
    assert mesh.zero_sharding(tree, 2) == {"a": 0, "b": [None], "c": None}


def test_collectives_of_one_process_are_the_identity():
    """A group of None is a group of one: nothing is sent, the gradients
    are only divided, a ppermute is a copy, a replicated reduction is the
    value with an identity backward, a ZeRO gather returns the shard."""
    g = [torch.full((3,), 4.0), torch.ones(2, 2)]
    collectives.reduce_gradients(g, None, divide=2.0)
    assert torch.equal(g[0], torch.full((3,), 2.0)) and torch.equal(g[1], torch.full((2, 2), 0.5))
    x = torch.arange(4.0, requires_grad=True)
    y = collectives.ppermute(x, None, 1)
    (y * 3).sum().backward()
    assert torch.equal(y, x.detach()) and torch.equal(x.grad, torch.full((4,), 3.0))
    x.grad = None
    r = collectives.all_reduce_replicated(x, None, mean=True)
    r.sum().backward()
    assert torch.equal(r, x.detach()) and torch.equal(x.grad, torch.ones(4))
    x.grad = None
    full = collectives.gather_leaf(x, 0, None)
    (full * 2).sum().backward()
    assert torch.equal(full, x.detach()) and torch.equal(x.grad, torch.full((4,), 2.0))


def test_training_path_takes_strided_streams():
    """A rank's token range of a stream is a strided T-slice: ``pad_steps``
    hands the autograd Functions contiguous streams (the CUDA kernels take
    no other), and ``wkv7`` / ``wkv6`` under autograd give a slice the
    values and gradients of its contiguous copy (bit for bit)."""
    from visualrwkv_torch.ops.padding import pad_steps
    from visualrwkv_torch.ops.wkv6 import wkv6
    from visualrwkv_torch.ops.wkv7 import wkv7

    gen = torch.Generator().manual_seed(0)
    full = [torch.randn(2, 64, 2, 32, generator=gen) * 0.5 for _ in range(6)]
    full[1] = -torch.nn.functional.softplus(full[1]) - 0.5
    part = [x[:, 16:48] for x in full]
    assert not part[0].is_contiguous()
    assert all(x.is_contiguous() for x in pad_steps(part, 1, 32))
    u = torch.randn(2, 32, generator=gen)
    for fn, n in ((lambda *s: wkv7(*s), 6), (lambda *s: wkv6(*s, u), 4)):
        outs = []
        for xs in (part[:n], [x.contiguous() for x in part[:n]]):
            xs = [x.clone().requires_grad_(True) if x.is_contiguous() else x.detach().requires_grad_(True)
                  for x in xs]
            y, s = fn(*xs)
            outs.append((y, s, torch.autograd.grad((y ** 2).sum() + s.sum(), xs)))
        (y1, s1, g1), (y2, s2, g2) = outs
        assert torch.equal(y1, y2) and torch.equal(s1, s2) and all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("local_rank,process_id,want", [(None, 1, 1), (None, 3, 1), ("0", 1, 0)])
def test_initialize_binds_the_process_to_its_card(monkeypatch, local_rank, process_id, want):
    """A CUDA group's device: ``LOCAL_RANK`` where the launcher sets it, else
    the process id modulo the visible cards (here 2). ``set_device`` and
    NCCL's ``device_id`` get the same card, and :func:`device_for` then
    answers the card that was set (the CUDA calls stand in for a host with 2
    cards; ``init_process_group`` is recorded, not run)."""
    import torch.distributed as dist

    calls, current = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: current.append(torch.device(d).index))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[-1])
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    for name in ("LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES, distributed.ENV_PROCESS_ID):
        monkeypatch.delenv(name, raising=False)
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert distributed.initialize("localhost:1234", num_processes=4, process_id=process_id)
    (args, kw), = calls
    assert args == ("nccl",) and kw["rank"] == process_id and kw["world_size"] == 4
    assert current == [want] and kw["device_id"] == torch.device("cuda", want)
    assert distributed.device_for("cuda") == torch.device("cuda", want)


@pytest.mark.parametrize("family", ["wkv7", "wkv6"])
def test_ring_entry_states_over_stacked_shards(family):
    """``_ring_entry_states`` with its exchange as a roll over 4 shards
    stacked along B (the form the card's check drives) gives the whole
    sequence's y and final state from an initial state (relative error
    below 1e-5) and its gradients, through the zero and identity runs
    (below 1e-4)."""
    from torch_parallel_worker import RING_ORDER, ring_inputs

    from visualrwkv_torch.ops.wkv6 import wkv6
    from visualrwkv_torch.ops.wkv7 import wkv7
    from visualrwkv_torch.ops.wkv_sp import _ring_entry_states

    ins, cot = ring_inputs(family, True)
    xs = [ins[k].clone().requires_grad_(True) for k in RING_ORDER[family] if k != "u"]
    s0 = ins["s0"].clone().requires_grad_(True)
    extra = () if family == "wkv7" else (ins["u"],)
    op = lambda *s, initial_state: (wkv7 if family == "wkv7" else wkv6)(*s, *extra, initial_state=initial_state)
    D, (B, T, H, N) = 4, xs[0].shape

    def ring():
        stacked = [x.reshape(B, D, T // D, H, N).transpose(0, 1).reshape(D * B, T // D, H, N) for x in xs]
        call = lambda S: op(*stacked, initial_state=S)
        z0 = torch.cat([s0, s0.new_zeros((D - 1) * B, H, N, N)])
        is_first = (torch.arange(D * B) < B).view(-1, 1, 1, 1)
        roll = lambda S: S.view(D, B, H, N, N).roll(1, 0).view(D * B, H, N, N)
        y, s = call(_ring_entry_states(call, z0, D, is_first, roll))
        return y.reshape(D, B, T // D, H, N).transpose(0, 1).reshape(B, T, H, N), s[-B:]

    outs = []
    for fn in (lambda: op(*xs, initial_state=s0), ring):
        y, s = fn()
        grads = torch.autograd.grad((y * cot["y"]).sum() + (s * cot["s"]).sum(), xs + [s0])
        outs.append((y.detach(), s.detach(), grads))
    (y, s, g), (y_r, s_r, g_r) = outs
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    assert rel(y_r, y) < 1e-5 and rel(s_r, s) < 1e-5
    assert all(rel(a, b) < 1e-4 for a, b in zip(g_r, g))
