"""The port's command line (counterpart of the repo's ``main.py``): a grid row
of the experiment grids -> ``get_dataset`` / ``get_model`` / ``get_trainer``
-> ``train`` -> the final evaluation -> the optional six-slice inductive
evaluation, or the offline preprocessing of a raw dataset.

    python -m inductive_recommendation_tpu_torch --grid gowalla --list
    python -m inductive_recommendation_tpu_torch --preprocess gowalla --data-path RAW --out-path data/Gowalla/time
    python -m inductive_recommendation_tpu_torch --grid gowalla --index 2 --stage test --inductive 26872 36882
    python -m inductive_recommendation_tpu_torch --grid gowalla --index 1 --device cpu
    torchrun --standalone --nproc_per_node 4 -m inductive_recommendation_tpu_torch --grid gowalla --index 2 \
        --mesh 1,4 --mesh-mode edge

The grids' dataset paths are relative (``data/Gowalla/time``), and the
trainer writes ``checkpoints/``: both are under the working directory. The
run prints the JAX ``main.py``'s lines, and last one JSON object with its
keys (model, trainer, best_val_ndcg, <stage>_ndcg@20, <stage>_recall@20).
With ``--mesh`` every rank of the torchrun launch (one a card, NCCL; gloo
with ``--device cpu``) runs the same program and rank 0 prints, the line
before the JSON object being its SpMM launches by route and collectives by
kind (``launches: {...}``).
"""

from __future__ import annotations

import argparse
import json

import torch.distributed as dist

from inductive_recommendation_tpu_torch import configs
from inductive_recommendation_tpu_torch.data import get_dataset
from inductive_recommendation_tpu_torch.models import get_model
from inductive_recommendation_tpu_torch.ops.csr_spmm import spmm_csr_cuda
from inductive_recommendation_tpu_torch.parallel.collectives import counts as collective_counts
from inductive_recommendation_tpu_torch.parallel.mesh import axis_size, init_distributed, make_mesh
from inductive_recommendation_tpu_torch.train import get_trainer
from inductive_recommendation_tpu_torch.utils import init_run, set_seed

RAW_DATASETS = {"gowalla": "GowallaDataset", "yelp": "YelpDataset", "amazon": "AmazonDataset"}


def build_argparser():
    p = argparse.ArgumentParser(
        description="Inductive-recommendation runner on CUDA cards (the PyTorch port)",
        epilog="With --mesh, launch one process a card: torchrun --standalone --nproc_per_node N "
        "-m inductive_recommendation_tpu_torch ... --mesh D,S",
    )
    p.add_argument("--grid", choices=["gowalla", "yelp", "amazon", "alibaba", "ml"], default="gowalla")
    p.add_argument("--index", type=int, default=0, help="grid entry index")
    p.add_argument("--list", action="store_true", help="print the grid and exit")
    p.add_argument("--log-path", default=None, help="redirect output via init_run")
    p.add_argument("--seed", type=int, default=2021)
    p.add_argument("--n-epochs", type=int, default=None, help="override epochs")
    p.add_argument("--stage", choices=["val", "test"], default="val", help="final eval split")
    p.add_argument(
        "--inductive", nargs=2, type=int, metavar=("N_OLD_USERS", "N_OLD_ITEMS"), default=None,
        help="run the six-slice inductive evaluation after training",
    )
    p.add_argument("--writer", action="store_true", help="TensorBoard logging (needs the tensorboard package)")
    p.add_argument(
        "--mesh", default=None, metavar="N_DATA,N_MODEL",
        help="train over a ('data', 'model') mesh of the torchrun ranks, e.g. '2,2'; 'auto' puts every rank on "
        "'model'. Same-seed losses match the single-device run",
    )
    p.add_argument(
        "--mesh-mode", choices=["data", "edge"], default="data",
        help="'data': data-parallel batches, embedding tables row-sharded over 'model' (every trainer). "
        "'edge': the graph, the table and its Adam moments sharded over 'model', batches over 'data' "
        "(every model with a graph propagation: LightGCN, IGCN, IMF, the DOSE variants, SGL, HALF, NGCF, "
        "IMCGAE, IDCF_LGCN, AttIGCN)",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device to run on, e.g. 'cpu' for the plain PyTorch path (default: the current CUDA card)",
    )
    p.add_argument(
        "--preprocess", choices=sorted(RAW_DATASETS), default=None,
        help="parse a raw dataset, k-core filter, chronologically split, and write train/val/test.txt "
        "(the reference's implied offline step: GowallaDataset/... -> output_dataset, dataset.py:133-137)",
    )
    p.add_argument("--data-path", default=None, help="raw dataset directory")
    p.add_argument("--out-path", default=None, help="output dir for train/val/test.txt")
    p.add_argument("--min-inter", type=int, default=10, help="k-core threshold")
    p.add_argument(
        "--split", nargs=3, type=float, metavar=("TRAIN", "VAL", "TEST"), default=[0.7, 0.1, 0.2],
        help="chronological split ratios",
    )
    return p


def preprocess(args):
    if not args.data_path or not args.out_path:
        raise SystemExit("--preprocess requires --data-path and --out-path")
    name = RAW_DATASETS[args.preprocess]
    dataset = get_dataset(
        {"name": name, "path": args.data_path, "min_inter": args.min_inter, "split_ratio": list(args.split)}
    )
    dataset.output_dataset(args.out_path)
    print(
        f"{name}: {dataset.n_users} users x {dataset.n_items} items, "
        f"{len(dataset.train_array)} train interactions -> {args.out_path}"
    )
    return dataset


def summary_writer():
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise SystemExit(f"--writer needs the tensorboard package, which this Python cannot import ({e})") from e
    return SummaryWriter()


def main(argv=None):
    """Runs the command line. Returns the dataset for ``--preprocess``, None
    for ``--list``, else the dict printed as the last line."""
    args = build_argparser().parse_args(argv)
    if args.preprocess:
        return preprocess(args)

    grid = getattr(configs, f"get_{args.grid}_config")(None)
    if args.list:
        for i, (d, m, t) in enumerate(grid):
            print(f"[{i}] {m['name']} + {t['name']} on {d['path']}")
        return None

    mesh, joined = None, False
    if args.mesh:
        joined = not dist.is_initialized()  # this run joins the group, and leaves it at the end
        init_distributed(args.device)
        mesh = make_mesh() if args.mesh == "auto" else make_mesh(*(int(x) for x in args.mesh.split(",")))
    rank0 = mesh is None or dist.get_rank() == 0
    if args.log_path and rank0:
        init_run(args.log_path, args.seed)
    else:
        set_seed(args.seed)
    if mesh is not None and rank0:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over {mesh.size()} ranks, {args.mesh_mode} mode")

    dataset_config, model_config, trainer_config = grid[args.index]
    trainer_config = dict(trainer_config, seed=args.seed)
    if args.n_epochs is not None:
        trainer_config["n_epochs"] = args.n_epochs
    dataset = get_dataset(dataset_config)
    if mesh is not None and args.mesh_mode == "data":
        # row-sharded tables pad to the 'model' axis size
        model_config = dict(model_config, table_align=axis_size(mesh, "model"))
    model = get_model(model_config, dataset, device=args.device)
    trainer = get_trainer(trainer_config, dataset, model, mesh=mesh, mesh_mode=args.mesh_mode)
    writer = summary_writer() if args.writer and rank0 else None

    best_ndcg = trainer.train(verbose=True, writer=writer)
    results, metrics = trainer.eval(args.stage)
    if rank0:
        print(f"Best NDCG: {best_ndcg:.5f}")
        print(f"{args.stage} result. {results}")
    if args.inductive:
        trainer.inductive_eval(*args.inductive)
    if writer is not None:
        writer.close()
    line = {
        "model": model_config["name"],
        "trainer": trainer_config["name"],
        "best_val_ndcg": float(best_ndcg),
        f"{args.stage}_ndcg@20": metrics["NDCG"].get(20),
        f"{args.stage}_recall@20": metrics["Recall"].get(20),
    }
    if mesh is not None and rank0:
        # what this rank launched: the SpMM kernel by route, the collectives by kind
        print("launches: " + json.dumps({
            "spmm_by_route": {k: v for k, v in spmm_csr_cuda.route_launches.items() if v},
            "collectives_by_kind": dict(collective_counts.by_kind),
        }))
    if rank0:
        print(json.dumps(line))
    if joined:
        dist.destroy_process_group()
    return line


__all__ = ["build_argparser", "main", "preprocess"]
