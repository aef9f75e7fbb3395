"""Helpers of the port's tests that import no JAX, so that the card tests
(tests/test_torch_cuda.py, run with --noconftest where JAX is absent) can
use them too."""

import torch

from cocosnet_tpu_torch.nn.blocks import Attention
from cocosnet_tpu_torch.nn.layers import Conv2d, PReLU


# The JAX side's compiles in the port's tests: LLVM at its lowest level and
# without its expensive passes. A flagship train step's compile took 18.9 s
# against 31.4 s at the default level alone on an 8-core host, its losses
# within 3e-7 relative of the default build's (the tests' tolerances are
# 5e-4 and wider).
XLA_QUICK = {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True}


def jit_quick(fn, *args):
    """fn jitted and compiled for the shapes of args under XLA_QUICK (JAX
    is imported here, not at the module's top: the card tests import this
    module where JAX is absent)."""
    import jax
    return jax.jit(fn).lower(*args).compile(XLA_QUICK)


def condition(module, seed):
    """Weights at unit signal scale: conv kernels at 1/sqrt(fan_in),
    biases at 0.1, PReLU slopes 0.2, attention gates 0.5, and the spectral
    u/v the leading singular vectors, so sigma is the spectral norm (the
    init leaves sigma near 0 and the output near 0)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv2d):
                w = m.weight if m.weight_norm is None else m.weight_orig
                w.copy_(torch.randn(w.shape, generator=g)
                        * w[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
                if m.weight_norm == "spectral":
                    u, _, vh = torch.linalg.svd(
                        w.reshape(w.shape[0], -1).double(),
                        full_matrices=False)
                    m.weight_u.copy_(u[:, 0])
                    m.weight_v.copy_(vh[0])
            elif isinstance(m, PReLU):
                m.weight.fill_(0.2)
            elif isinstance(m, Attention):
                m.gamma.fill_(0.5)


# The conv3x3.cu calls of one forward at published widths (256 px, ngf
# 64, bf16): ((B, H, W, Cin, Cout, reflect ring, statistics), calls), as
# nn.layers.conv2d routes the convolutions of pix2pix.inference at the
# benchmark's ADE20k (B6, and B1 for a request) and DeepFashion (B4)
# configurations: 100, 100 and 84 calls.
_ADE20K_CONVS = (
    ((64, 64, 128, 512, True, False), 28),
    ((64, 64, 407, 407, True, True), 16),
    ((64, 64, 512, 512, True, False), 8),
    ((64, 64, 151, 128, True, False), 7),
    ((64, 64, 128, 256, True, False), 6),
    ((128, 128, 128, 256, True, False), 4),
    ((256, 256, 128, 128, True, False), 4),
    ((64, 64, 512, 256, True, False), 3),
    ((64, 64, 256, 256, True, False), 3),
    ((64, 64, 154, 128, True, False), 3),
    ((128, 128, 154, 128, True, False), 3),
    ((128, 128, 128, 128, True, False), 3),
    ((256, 256, 154, 128, True, False), 3),
    ((256, 256, 128, 64, True, False), 3),
    ((128, 128, 128, 256, False, True), 2),
    ((64, 64, 512, 512, False, True), 2),
    ((128, 128, 256, 128, True, False), 1),
    ((256, 256, 64, 64, True, False), 1))
_DEEPFASHION_CONVS = (
    ((64, 64, 128, 512, True, False), 28),
    ((64, 64, 256, 256, True, True), 16),
    ((64, 64, 512, 512, True, False), 8),
    ((64, 64, 128, 256, True, False), 6),
    ((128, 128, 128, 256, True, False), 4),
    ((256, 256, 128, 128, True, False), 4),
    ((64, 64, 512, 256, True, False), 3),
    ((64, 64, 256, 256, True, False), 3),
    ((128, 128, 128, 128, True, False), 3),
    ((256, 256, 128, 64, True, False), 3),
    ((128, 128, 128, 256, False, True), 2),
    ((64, 64, 512, 512, False, True), 2),
    ((128, 128, 256, 128, True, False), 1),
    ((256, 256, 64, 64, True, False), 1))
FORWARD_CONVS = {
    name: tuple(((b,) + shape, n) for shape, n in convs)
    for name, b, convs in (("ade20k-b6", 6, _ADE20K_CONVS),
                           ("ade20k-b1", 1, _ADE20K_CONVS),
                           ("deepfashion-b4", 4, _DEEPFASHION_CONVS))}


# ----------------------------------------------------------------- jobs
# The multi-process tests run the port in gloo workers on the CPU, spawned
# with a file:// rendezvous under the test's tmp_path (parallel test
# workers never share a port). The workers import only the port: the JAX
# references are computed in the test process.

def spawn_job(fn, world: int, tmp_path, *args) -> None:
    """Runs fn(rank, world, init_method, *args) in `world` spawned
    processes and joins them; raises if one fails."""
    import uuid

    import torch.multiprocessing as mp
    init = "file://" + str(tmp_path / f"rendezvous_{uuid.uuid4().hex}")
    mp.start_processes(fn, args=(world, init, *args), nprocs=world,
                       join=True, start_method="spawn")


def _join(rank, world, init, data, model):
    import torch.distributed as dist

    from cocosnet_tpu_torch import mesh as M
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    mesh = M.create_mesh(data, model)
    M.set_global_mesh(mesh)
    return mesh


def mesh_worker(rank, world, init, data, model, out_dir):
    """The layout and groups of a (data, model) mesh: this rank's indices
    and the sums of the ranks over its data and its model group."""
    import torch.distributed as dist

    from cocosnet_tpu_torch import mesh as M
    mesh = _join(rank, world, init, data, model)
    try:
        mine = torch.tensor([float(rank)])
        over_data, over_model = mine.clone(), mine.clone()
        if mesh.data_group is not None:
            dist.all_reduce(over_data, group=mesh.data_group)
        if mesh.model_group is not None:
            dist.all_reduce(over_model, group=mesh.model_group)
        torch.save(dict(data_rank=mesh.data_rank, model_rank=mesh.model_rank,
                        over_data=float(over_data), over_model=float(over_model),
                        gathered=M.gather_data(mine[None]).reshape(-1)),
                   f"{out_dir}/rank{rank}.pt")
    finally:
        M.shutdown()


def sp_worker(rank, world, init, data, model, cases_file, out_dir):
    """attend_sp on each case of cases_file ({name: dict(f, g, v, tau, mk,
    use_pallas)}, the whole batch) for this rank's data shard of the batch,
    with d/d(f, g, v) of sum(sin(out)); saves {name: (out, grads)}."""
    from cocosnet_tpu_torch import mesh as M
    from cocosnet_tpu_torch.ops.corr_sp import attend_sp
    mesh = _join(rank, world, init, data, model)
    try:
        res = {}
        for name, c in torch.load(cases_file).items():
            b = c["f"].shape[0] // data
            rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
            leaves = [c[k][rows].clone().requires_grad_() for k in "fgv"]
            out = attend_sp(*leaves, c["tau"], match_kernel=c["mk"],
                            pono_c=True, use_pallas=c["use_pallas"],
                            model=model)
            torch.sin(out).sum().backward()
            res[name] = (out.detach(), [t.grad for t in leaves])
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        M.shutdown()


def parallel_step(opt, batch, seed: int = 0):
    """On this process's rank of the registered mesh: the weights drawn as
    `condition(net, seed + i)` draws them, then with opt.isTrain one train
    step (make_train_step at epoch 1's learning rates) on this rank's data
    shard of the numpy batch, else one inference step. Returns the fake
    (this shard's), the reported losses and the trained nets' parameters
    after the step."""
    from cocosnet_tpu_torch import mesh as M
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.train import state as TS
    from cocosnet_tpu_torch.train import steps as ST
    mesh = M.global_mesh()
    nets = P.Pix2PixNets(opt, device="cpu", seed=seed)
    for i, net in enumerate(nets.modules()):
        condition(net, seed + i)
    b = opt.batchSize // mesh.data
    shard = {k: v[mesh.data_rank * b:(mesh.data_rank + 1) * b]
             for k, v in batch.items()}
    if not opt.isTrain:
        fake = ST.make_inference_step(nets)(shard)["fake_image"]
        return dict(fake=fake.clone())
    state = TS.create_train_state(opt, nets)
    losses, visuals = ST.make_train_step(nets)(
        state, shard, TS.lrs_for_epoch(opt, 1))
    return dict(fake=visuals["fake_image"].clone(),
                losses={k: float(v) for k, v in losses.items()},
                params={net: {k: p.detach().clone() for k, p in
                              getattr(nets, net).named_parameters()}
                        for net in ("gen", "corr", "disc")})


def parallel_chunk(opt, batches, seed: int = 0):
    """parallel_step's run for make_multi_train_step: the weights drawn as
    there, then one chunk of len(batches) steps (each this rank's data
    shard of its numpy batch). Returns the losses ({term: (K,)}) and the
    trained nets' parameters after the chunk."""
    from cocosnet_tpu_torch import mesh as M
    from cocosnet_tpu_torch import pix2pix as P
    from cocosnet_tpu_torch.train import state as TS
    from cocosnet_tpu_torch.train import steps as ST
    mesh = M.global_mesh()
    nets = P.Pix2PixNets(opt, device="cpu", seed=seed)
    for i, net in enumerate(nets.modules()):
        condition(net, seed + i)
    b = opt.batchSize // mesh.data
    shards = [{k: v[mesh.data_rank * b:(mesh.data_rank + 1) * b]
               for k, v in batch.items()} for batch in batches]
    state = TS.create_train_state(opt, nets)
    losses, _ = ST.make_multi_train_step(nets)(
        state, shards, TS.lrs_for_epoch(opt, 1))
    return dict(losses={k: v.clone() for k, v in losses.items()},
                params={net: {k: p.detach().clone() for k, p in
                              getattr(nets, net).named_parameters()}
                        for net in ("gen", "corr", "disc")})


def chunk_worker(rank, world, init, data, model, opt, batches, out_dir):
    """parallel_chunk on this rank of a (data, model) job; saves its
    result, with the message of mesh.check_capturable's refusal (a gloo
    job's collectives cannot be captured on the card)."""
    from cocosnet_tpu_torch import mesh as M
    _join(rank, world, init, data, model)
    try:
        out = parallel_chunk(opt, batches)
        try:
            M.check_capturable()
            out["refused"] = ""
        except RuntimeError as err:
            out["refused"] = str(err)
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        M.shutdown()


def step_worker(rank, world, init, data, model, opts, batch, out_dir):
    """parallel_step of each of `opts` on this rank of a (data, model) job;
    saves the list of results."""
    from cocosnet_tpu_torch import mesh as M
    _join(rank, world, init, data, model)
    try:
        torch.save([parallel_step(opt, batch) for opt in opts],
                   f"{out_dir}/rank{rank}.pt")
    finally:
        M.shutdown()


def bn_worker(rank, world, init, data, model, x, w, out_dir):
    """A synchronized BatchNorm (affine, train mode) on this rank's data
    shard of x, then d/d(x, weight, bias) of sum(y * w shard); saves
    (y, x.grad, weight.grad, bias.grad, running_mean, running_var)."""
    from cocosnet_tpu_torch import mesh as M
    from cocosnet_tpu_torch.nn.norms import BatchNorm
    mesh = _join(rank, world, init, data, model)
    try:
        b = x.shape[0] // data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        bn = BatchNorm(x.shape[-1]).train()
        xs = x[rows].clone().requires_grad_()
        y = bn(xs)
        (y * w[rows]).sum().backward()
        torch.save((y.detach(), xs.grad, bn.weight.grad, bn.bias.grad,
                    bn.running_mean, bn.running_var),
                   f"{out_dir}/rank{rank}.pt")
    finally:
        M.shutdown()
