"""Per-dataset experiment grids: the port's own copy of
``inductive_recommendation_tpu/configs/grids.py``, equal to it dict for dict.

Each ``get_*_config(device=None)`` returns a list of
``(dataset_config, model_config, trainer_config)`` dict triples with the
exact model/trainer names and hyperparameters of reference config.py
(Gowalla :1-100, Yelp :103-203, Amazon :206-289, Alibaba :292-408,
ML-1M :411-527).

The ``device`` argument is recorded in each config; the port places a
model by ``get_model``'s ``device`` argument, not by the config. The
reference's ``dataloader_num_workers`` is carried along but unused
(sampling is on the device).
"""

from __future__ import annotations

TOPKS = list(range(5, 101, 5))
TOPKS = [1] + TOPKS  # [1, 5, 10, ..., 100] (config.py:9)


def _base_trainer(name, device, lr, l2_reg, **extra):
    cfg = {
        "name": name,
        "optimizer": "Adam",
        "lr": lr,
        "l2_reg": l2_reg,
        "device": device,
        "n_epochs": 1000,
        "batch_size": 2048,
        "dataloader_num_workers": 6,
        "test_batch_size": 512,
        "topks": list(TOPKS),
    }
    cfg.update(extra)
    return cfg


def _eval_only_trainer(device, **extra):
    cfg = {
        "name": "BasicTrainer",
        "device": device,
        "n_epochs": 0,
        "test_batch_size": 512,
        "topks": list(TOPKS),
    }
    cfg.update(extra)
    return cfg


def get_gowalla_config(device=None):
    dataset_config = {
        "name": "ProcessedDataset",
        "path": "data/Gowalla/time",
        "device": device,
    }
    grid = []

    grid.append(
        (
            dataset_config,
            {"name": "MF", "embedding_size": 64, "device": device},
            _base_trainer("BPRTrainer", device, 1.0e-4, 1.0e-3),
        )
    )
    grid.append(
        (
            dataset_config,
            {"name": "LightGCN", "embedding_size": 64, "n_layers": 3, "device": device},
            _base_trainer("BPRTrainer", device, 1.0e-3, 1.0e-4),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IGCN",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
            },
            _base_trainer("IGCNTrainer", device, 1.0e-3, 0.0, aux_reg=0.01),
        )
    )
    grid.append(
        (
            dataset_config,
            {"name": "ItemKNN", "k": 1000, "device": device},
            _eval_only_trainer(device),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "NGCF",
                "embedding_size": 64,
                "layer_sizes": [64, 64, 64],
                "device": device,
                "dropout": 0.1,
            },
            _base_trainer("BPRTrainer", device, 1.0e-3, 1.0e-3),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "MultiVAE",
                "layer_sizes": [64, 32],
                "device": device,
                "dropout": 0.7,
            },
            _base_trainer(
                "MLTrainer", device, 1.0e-3, 1.0e-4, kl_reg=0.2, batch_size=512
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IMF",
                "embedding_size": 64,
                "n_layers": 0,
                "device": device,
                "dropout": 0.1,
                "feature_ratio": 1.0,
            },
            _base_trainer("IGCNTrainer", device, 1.0e-3, 1.0e-5, aux_reg=0.1),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IMCGAE",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
            },
            _base_trainer("BPRTrainer", device, 1.0e-3, 0.0),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IDCF_LGCN",
                "embedding_size": 64,
                "n_layers": 3,
                "n_headers": 4,
                "lgcn_path": "lgcn.pth",
                "device": device,
            },
            _base_trainer(
                "IDCFTrainer", device, 1.0e-3, 1.0e-4, contrastive_reg=1.0e-3
            ),
        )
    )
    neumf_ds = dict(dataset_config, neg_ratio=4)
    grid.append(
        (
            neumf_ds,
            {
                "name": "NeuMF",
                "embedding_size": 64,
                "device": device,
                "layer_sizes": [64, 64, 64],
            },
            _base_trainer(
                "BCETrainer",
                device,
                1.0e-3,
                1.0e-3,
                test_batch_size=64,
                mf_pretrain_epochs=100,
                mlp_pretrain_epochs=100,
                max_patience=100,
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "DOSE_aug",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
                "aug_num": 500000,
            },
            _base_trainer(
                "DOSEaugTrainer",
                device,
                1.0e-3,
                0.0,
                contrastive_reg=1.0e-1,
                aux_reg=0.001,
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "DOSE_drop3",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
                "aug_num": 500000,
                "aug_rate": 0.5,
            },
            _base_trainer(
                "DOSEdropTrainer",
                device,
                1.0e-3,
                0.0,
                contrastive_reg=1.0e-1,
                aux_reg=0.001,
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "DOSE_aug_drop2",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
                "aug_num": 100000,
            },
            _base_trainer(
                "DOSEdropTrainer",
                device,
                1.0e-3,
                0.0,
                contrastive_reg=1.0e-1,
                aux_reg=0.001,
            ),
        )
    )
    return grid


def get_yelp_config(device=None):
    dataset_config = {
        "name": "ProcessedDataset",
        "path": "data/Yelp/time",
        "device": device,
    }
    grid = []
    grid.append(
        (
            dataset_config,
            {"name": "MF", "embedding_size": 64, "device": device},
            _base_trainer("BPRTrainer", device, 1.0e-3, 1.0e-3),
        )
    )
    grid.append(
        (
            dataset_config,
            {"name": "LightGCN", "embedding_size": 64, "n_layers": 3, "device": device},
            _base_trainer("BPRTrainer", device, 1.0e-3, 1.0e-4),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IGCN",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
            },
            _base_trainer("IGCNTrainer", device, 1.0e-3, 0.0, aux_reg=0.01),
        )
    )
    grid.append(
        (
            dataset_config,
            {"name": "ItemKNN", "k": 1000, "device": device},
            _eval_only_trainer(device),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "NGCF",
                "embedding_size": 64,
                "layer_sizes": [64, 64, 64],
                "device": device,
                "dropout": 0.3,
            },
            _base_trainer("BPRTrainer", device, 1.0e-3, 1.0e-3),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "MultiVAE",
                "layer_sizes": [64, 32],
                "device": device,
                "dropout": 0.7,
            },
            _base_trainer(
                "MLTrainer", device, 1.0e-3, 1.0e-4, kl_reg=0.2, batch_size=512
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "DOSE_drop2",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
                "aug_num": 500000,
                "aug_rate": 0.5,
            },
            _base_trainer("IGCNTrainer", device, 1.0e-3, 1.0e-5, aux_reg=0.01),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IMCGAE",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
            },
            _base_trainer("BPRTrainer", device, 1.0e-3, 0.0),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IDCF_LGCN",
                "embedding_size": 64,
                "n_layers": 3,
                "n_headers": 4,
                "lgcn_path": "lgcn.pth",
                "device": device,
            },
            _base_trainer(
                "IDCFTrainer", device, 1.0e-3, 1.0e-4, contrastive_reg=1.0e-3
            ),
        )
    )
    neumf_ds = dict(dataset_config, neg_ratio=4)
    grid.append(
        (
            neumf_ds,
            {
                "name": "NeuMF",
                "embedding_size": 64,
                "device": device,
                "layer_sizes": [64, 64, 64],
            },
            _base_trainer(
                "BCETrainer",
                device,
                1.0e-2,
                1.0e-2,
                test_batch_size=64,
                topks=[20],
                mf_pretrain_epochs=100,
                mlp_pretrain_epochs=100,
                max_patience=100,
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "DOSE_aug",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
                "aug_num": 800000,
            },
            _base_trainer(
                "DOSEaugTrainer",
                device,
                1.0e-3,
                0.0,
                contrastive_reg=1.0e-1,
                aux_reg=0.001,
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "DOSE_drop3",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
                "aug_num": 1000000,
                "aug_rate": 0.7,
            },
            _base_trainer(
                "DOSEdropTrainer",
                device,
                1.0e-3,
                0.0,
                contrastive_reg=1.0e-1,
                aux_reg=0.001,
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "DOSE_aug_drop2",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
                "aug_num": 300000,
            },
            _base_trainer(
                "DOSEdropTrainer",
                device,
                1.0e-3,
                0.0,
                contrastive_reg=1.0e-1,
                aux_reg=0.001,
            ),
        )
    )
    return grid


def get_amazon_config(device=None):
    dataset_config = {
        "name": "ProcessedDataset",
        "path": "data/Amazon/time",
        "device": device,
    }
    grid = []
    grid.append(
        (
            dataset_config,
            {"name": "MF", "embedding_size": 64, "device": device},
            _base_trainer("BPRTrainer", device, 1.0e-3, 1.0e-4),
        )
    )
    grid.append(
        (
            dataset_config,
            {"name": "LightGCN", "embedding_size": 64, "n_layers": 3, "device": device},
            _base_trainer("BPRTrainer", device, 1.0e-3, 1.0e-5),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IGCN",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.0,
                "feature_ratio": 1,
            },
            _base_trainer("IGCNTrainer", device, 1.0e-3, 0.0, aux_reg=0.01),
        )
    )
    grid.append(
        (
            dataset_config,
            {"name": "ItemKNN", "k": 10, "device": device},
            _eval_only_trainer(device),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "NGCF",
                "embedding_size": 64,
                "layer_sizes": [64, 64, 64],
                "device": device,
                "dropout": 0.3,
            },
            _base_trainer("BPRTrainer", device, 1.0e-3, 1.0e-4),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "MultiVAE",
                "layer_sizes": [64, 32],
                "device": device,
                "dropout": 0.7,
            },
            _base_trainer(
                "MLTrainer", device, 1.0e-3, 1.0e-5, kl_reg=0.2, batch_size=512
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IMF",
                "embedding_size": 64,
                "n_layers": 0,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1.0,
            },
            _base_trainer("IGCNTrainer", device, 1.0e-3, 1.0e-5, aux_reg=0.1),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IMCGAE",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.9,
            },
            _base_trainer("BPRTrainer", device, 1.0e-3, 0.0),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "DOSE_aug",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
                "aug_num": 1000000,
            },
            _base_trainer(
                "DOSEaugTrainer",
                device,
                1.0e-3,
                0.0,
                contrastive_reg=1.0e-1,
                aux_reg=0.001,
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "DOSE_aug",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 0.6,
                "aug_num": 1000000,
                "aug_rate": 0.7,
            },
            _base_trainer(
                "DOSEdropTrainer",
                device,
                1.0e-3,
                0.0,
                contrastive_reg=1.0e-1,
                aux_reg=0.001,
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "DOSE_aug_drop2",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
                "aug_num": 1000000,
            },
            _base_trainer(
                "DOSEdropTrainer",
                device,
                1.0e-3,
                0.0,
                contrastive_reg=1.0e-1,
                aux_reg=0.001,
            ),
        )
    )
    return grid


def _gowalla_style_grid(dataset_config, device, mf_lr=1.0e-4):
    """Alibaba and ML-1M repeat the Gowalla pattern (config.py:292-527)."""
    grid = []
    grid.append(
        (
            dataset_config,
            {"name": "MF", "embedding_size": 64, "device": device},
            _base_trainer("BPRTrainer", device, mf_lr, 1.0e-3),
        )
    )
    grid.append(
        (
            dataset_config,
            {"name": "LightGCN", "embedding_size": 64, "n_layers": 3, "device": device},
            _base_trainer("BPRTrainer", device, 1.0e-3, 1.0e-4),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IGCN",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
            },
            _base_trainer("IGCNTrainer", device, 1.0e-3, 0.0, aux_reg=0.01),
        )
    )
    grid.append(
        (
            dataset_config,
            {"name": "ItemKNN", "k": 1000, "device": device},
            _eval_only_trainer(device),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "NGCF",
                "embedding_size": 64,
                "layer_sizes": [64, 64, 64],
                "device": device,
                "dropout": 0.1,
            },
            _base_trainer("BPRTrainer", device, 1.0e-3, 1.0e-3),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "MultiVAE",
                "layer_sizes": [64, 32],
                "device": device,
                "dropout": 0.7,
            },
            _base_trainer(
                "MLTrainer", device, 1.0e-3, 1.0e-4, kl_reg=0.2, batch_size=512
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IMF",
                "embedding_size": 64,
                "n_layers": 0,
                "device": device,
                "dropout": 0.1,
                "feature_ratio": 1.0,
            },
            _base_trainer("IGCNTrainer", device, 1.0e-3, 1.0e-5, aux_reg=0.1),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IMCGAE",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
            },
            _base_trainer("BPRTrainer", device, 1.0e-3, 0.0),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "IDCF_LGCN",
                "embedding_size": 64,
                "n_layers": 3,
                "n_headers": 4,
                "lgcn_path": "lgcn.pth",
                "device": device,
            },
            _base_trainer(
                "IDCFTrainer", device, 1.0e-3, 1.0e-4, contrastive_reg=1.0e-3
            ),
        )
    )
    neumf_ds = dict(dataset_config, neg_ratio=4)
    grid.append(
        (
            neumf_ds,
            {
                "name": "NeuMF",
                "embedding_size": 64,
                "device": device,
                "layer_sizes": [64, 64, 64],
            },
            _base_trainer(
                "BCETrainer",
                device,
                1.0e-3,
                1.0e-3,
                test_batch_size=64,
                mf_pretrain_epochs=100,
                mlp_pretrain_epochs=100,
                max_patience=100,
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "DOSE_aug",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
                "aug_num": 500000,
            },
            _base_trainer(
                "DOSEaugTrainer",
                device,
                1.0e-3,
                0.0,
                contrastive_reg=1.0e-1,
                aux_reg=0.001,
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "DOSE_drop3",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
                "aug_num": 500000,
                "aug_rate": 0.5,
            },
            _base_trainer(
                "DOSEdropTrainer",
                device,
                1.0e-3,
                0.0,
                contrastive_reg=1.0e-1,
                aux_reg=0.001,
            ),
        )
    )
    grid.append(
        (
            dataset_config,
            {
                "name": "DOSE_aug_drop2",
                "embedding_size": 64,
                "n_layers": 3,
                "device": device,
                "dropout": 0.3,
                "feature_ratio": 1,
                "aug_num": 100000,
            },
            _base_trainer(
                "DOSEdropTrainer",
                device,
                1.0e-3,
                0.0,
                contrastive_reg=1.0e-1,
                aux_reg=0.001,
            ),
        )
    )
    return grid


def get_alibaba_config(device=None):
    dataset_config = {
        "name": "ProcessedDataset",
        "path": "data/alibaba/time",
        "device": device,
    }
    return _gowalla_style_grid(dataset_config, device)


def get_ml_config(device=None):
    dataset_config = {
        "name": "ProcessedDataset",
        "path": "data/ml-1m/time",
        "device": device,
    }
    return _gowalla_style_grid(dataset_config, device)
