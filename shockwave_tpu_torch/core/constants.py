"""Shared model/dataset constants for the workload families (a copy of
`shockwave_tpu/core/constants.py`).

The five active model families match the reference's job table
(reference: scheduler/job_table.py:110-130); dataset sizes match
scheduler/scheduler.py:73-81 so that step<->epoch conversions agree
with the reference simulator exactly.
"""
import math

# Samples per epoch for each dataset.
DATASET_SIZES = {
    "CIFAR-10": 50000,
    "ImageNet": 100000,
    "Multi30k": 10000,
    "Wikitext-2": 59675,
    "ML-20M": 117907,
    "Pong": 4,
    "monet2photo": 6287,
}

# Model family -> dataset it trains on.
MODEL_DATASET = {
    "ResNet-18": "CIFAR-10",
    "ResNet-50": "ImageNet",
    "Transformer": "Multi30k",
    "LM": "Wikitext-2",
    "Recommendation": "ML-20M",
    "A3C": "Pong",
    "CycleGAN": "monet2photo",
}

# Largest batch size with a profiled throughput entry; adaptation never
# scales past these (reference: scheduler/scheduler.py:4756-4761).
MAX_BS = {
    "LM": 80,
    "ResNet-18": 256,
    "ResNet-50": 128,
    "Transformer": 128,
    "Recommendation": 8192,
    "A3C": 4,
    "CycleGAN": 1,
}

# Families whose job_type carries no "(batch size N)" suffix; the value is
# the implicit batch size their profiles are keyed under.
DEFAULT_BS = {
    "A3C": 4,
    "CycleGAN": 1,
}


def oracle_job_type(model: str, batch_size: int) -> str:
    """The job_type string used as the throughput-oracle key."""
    if model in DEFAULT_BS:
        return model
    return f"{model} (batch size {batch_size})"

def dataset_size(model: str) -> int:
    return DATASET_SIZES[MODEL_DATASET[model]]


def steps_per_epoch(model: str, batch_size: int) -> int:
    return math.ceil(dataset_size(model) / batch_size)


def num_epochs_for(model: str, batch_size: int, num_steps: int) -> int:
    """Total epochs implied by a step budget at a fixed batch size."""
    return math.ceil(num_steps / steps_per_epoch(model, batch_size))
