"""The port's side of the multi-rank parity test: four gloo ranks on the CPU.

    python tests/torch_parallel_ranks.py OUT_DIR

Spawns four processes (``torch.multiprocessing``, one thread each), joins
them in a gloo process group through a file store in ``OUT_DIR``, and
runs on each rank what ``tests/test_torch_parallel.py`` holds against the
reference's run on four host devices:

* ``compressed_allreduce``, int8 and bf16, over "data" on a (4, 1) mesh
  (each rank's block) and a (2, 2) mesh (DTensors sharded ``Shard(0)``);
* ``sharded_filterbank``, 8 channels over 4 ranks, and its divisibility
  refusal;
* the reference's parameters (pickled numpy trees the reference writes to
  ``OUT_DIR``, carried across by ``repro_torch.convert``) and AdamW's
  zero moments laid out by ``train_step_shardings`` + ``device_put`` on
  (2, 2) and on the multipod (2, 2, 1) mesh, and the parameters on the
  moments' shardings there (a dimension split over ("pod", "data"));
  ``init_train_state`` against ``lm_init`` + ``init_opt``;
* a checkpoint of the carried state written on (2, 2) and restored on
  (4, 1) with ``shardings=``.

Each rank writes ``OUT_DIR/port_rank<r>.npz``: every local block under
``<name>@<mesh coordinate>``.  Imports nothing of JAX.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

WORLD = 4
CONFIGS = ("qwen2-0.5b", "grok-1-314b", "deepseek-v3-671b")
MESHES = {"2x2": (("data", "model"), (2, 2)),
          "2x2x1": (("pod", "data", "model"), (2, 2, 1))}
FB = dict(wl=12, vbl=9, kind=1)         # the filterbank's operating point
STATE_WAIT_S = 240


def coord_key(name: str, mesh) -> str:
    return f"{name}@{','.join(str(c) for c in mesh.get_coordinate())}"


def _leaves(tree):
    from repro_torch.train.optimizer import tree_leaves
    return tree_leaves(tree)


def _wait_for(path: Path) -> None:
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > STATE_WAIT_S:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.1)


def _state(out: Path, name: str):
    """The reference's parameters of ``name`` (reduced) on the CPU, and
    AdamW's zero state."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.train.optimizer import OptConfig, init_opt
    with open(out / f"state_{name}.pkl", "rb") as f:
        params = lm_params_from_numpy(pickle.load(f), device="cpu")
    return params, init_opt(params, OptConfig())


def _blocks(res: dict, tag: str, state, mesh) -> None:
    for i, leaf in enumerate(_leaves(state)):
        res[coord_key(f"{tag}/{i}", mesh)] = leaf.to_local().numpy()


def rank_main(rank: int, out: str) -> None:
    torch.set_num_threads(1)
    out = Path(out)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm_init
    from repro_torch.parallel import sharded_filterbank
    from repro_torch.parallel.compress import compressed_allreduce
    from repro_torch.parallel.logical import (NamedSharding, PartitionSpec,
                                              device_put)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, OptState, init_opt
    from repro_torch.train.trainstep import (TrainConfig, init_train_state,
                                             train_step_shardings)
    inp = np.load(out / "inputs.npz")
    names = sorted({k.split(".")[1] for k in inp.files if k.startswith("g.")})
    res = {}

    # the compressed all-reduce over "data"
    m41 = make_host_mesh(8, 1, device="cpu")          # clamped to (4, 1)
    m22 = make_host_mesh(2, 2, device="cpu")
    assert tuple(m41.shape) == (4, 1) and tuple(m22.shape) == (2, 2)
    for codec in ("int8", "bf16"):
        for tag, mesh in (("4x1", m41), ("2x2", m22)):
            n = mesh.size(0)
            i = mesh.get_local_rank(0)
            if tag == "4x1":       # each rank's block
                def take(a):
                    per = a.shape[0] // n
                    return torch.from_numpy(a[i * per:(i + 1) * per].copy())
            else:                  # DTensors sharded over data
                def take(a):
                    return distribute_tensor(torch.from_numpy(a), mesh,
                                             [Shard(0), Replicate()])
            g = {k: take(inp[f"g.{k}"]) for k in names}
            e = {k: take(inp[f"e.{k}"]) for k in names}
            mean, err = compressed_allreduce(g, mesh, codec, axis="data",
                                             error_buf=e)
            for k in names:
                for what, t in (("mean", mean[k]), ("err", err[k])):
                    if tag == "2x2":
                        assert type(t) is type(g[k]), type(t)
                        t = t.to_local()
                    res[coord_key(f"ar/{codec}/{tag}/{what}/{k}",
                                  mesh)] = t.numpy()

    # the channel-sharded filterbank, 8 channels over 4 ranks
    y = sharded_filterbank(inp["fb.x"], inp["fb.h"], m41, **FB)
    res[coord_key("fb", m41)] = y.to_local().numpy()
    res["fb_full"] = y.full_tensor().numpy()
    try:
        sharded_filterbank(inp["fb.x"][:6], inp["fb.h"][:6], m41, **FB)
        res["fb_refused"] = np.array("")
    except ValueError as err:
        res["fb_refused"] = np.array(str(err))

    # init_train_state is lm_init + init_opt, laid out
    cfg = reduced(get_arch("qwen2-0.5b"))
    params, opt = init_train_state(cfg, TrainConfig(), m22, seed=0)
    want = lm_init(cfg, 0, device="cpu")
    want = (want, init_opt(want, OptConfig()))
    res["init_equal"] = np.array(all(
        torch.equal(a.full_tensor(), b) for a, b in
        zip(_leaves((params, opt)), _leaves(want))))

    # the reference's state carried across and laid out
    _wait_for(out / "state.ready")
    meshes = {tag: init_device_mesh("cpu", shape, mesh_dim_names=axes)
              for tag, (axes, shape) in MESHES.items()}
    for name in CONFIGS:
        params, opt = _state(out, name)
        for tag, mesh in meshes.items():
            p_sh, o_sh, _ = train_step_shardings(reduced(get_arch(name)),
                                                 mesh)
            rep = NamedSharding(mesh, PartitionSpec())
            state = (device_put(params, p_sh),
                     OptState(device_put(opt.step, rep),
                              device_put(opt.m, o_sh),
                              device_put(opt.v, o_sh)))
            _blocks(res, f"state/{name}/{tag}", state, mesh)
            if tag == "2x2x1":     # "embed" over ("pod", "data"), pod major
                _blocks(res, f"optlayout/{name}", device_put(params, o_sh),
                        mesh)
            if name == "qwen2-0.5b" and tag == "2x2":
                ckpt.save(state, 7, str(out / "port_ckpt"))
                like = state

    # the (2, 2) checkpoint restored on (4, 1)
    cfg = reduced(get_arch("qwen2-0.5b"))
    p_sh, o_sh, _ = train_step_shardings(cfg, m41)
    rep = NamedSharding(m41, PartitionSpec())
    restored, step = ckpt.restore(like, str(out / "port_ckpt"),
                                  shardings=(p_sh, OptState(rep, o_sh, o_sh)))
    assert step == 7
    _blocks(res, "restored/4x1", restored, m41)
    np.savez(out / f"port_rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    out = os.path.abspath(sys.argv[1])
    torch.multiprocessing.spawn(rank_main, args=(out,), nprocs=WORLD,
                                join=True)


if __name__ == "__main__":
    main()
