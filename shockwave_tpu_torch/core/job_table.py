"""Job template registry: the 5 active model families x batch sizes.

A copy of `shockwave_tpu/core/job_table.py`. The commands are the
trace's; on a port worker they resolve under the port's run dir
(`runtime/worker.py` `RUN_DIR`, `shockwave_tpu_torch/workloads`). The
A3C / CycleGAN templates exist but are excluded from the generator
table, as in the reference; their mains are `workloads/rl/main.py` and
`workloads/cyclegan/cyclegan.py`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class JobTemplate:
    model: str              # job_type string, e.g. "ResNet-18 (batch size 32)"
    command: str            # command with %s placeholder(s) for the data dir
    working_directory: str  # run dir relative to the workloads root
    num_steps_arg: str      # CLI flag the dispatcher appends the step cap to
    needs_data_dir: bool = True
    distributed: bool = False


def resnet18(batch_size: int) -> JobTemplate:
    return JobTemplate(
        model=f"ResNet-18 (batch size {batch_size})",
        command=f"python3 main.py --data_dir=%s/cifar10 --batch_size {batch_size}",
        working_directory="image_classification/cifar10",
        num_steps_arg="--num_steps",
        distributed=True,
    )


def resnet50(batch_size: int) -> JobTemplate:
    return JobTemplate(
        model=f"ResNet-50 (batch size {batch_size})",
        command=f"python3 main.py -j 4 -a resnet50 -b {batch_size} %s/imagenet/",
        working_directory="image_classification/imagenet",
        num_steps_arg="--num_minibatches",
        distributed=True,
    )


def transformer(batch_size: int) -> JobTemplate:
    return JobTemplate(
        model=f"Transformer (batch size {batch_size})",
        command=("python3 train.py -data %s/translation/multi30k.atok.low.pt "
                 f"-batch_size {batch_size} -proj_share_weight"),
        working_directory="translation",
        num_steps_arg="-step",
        distributed=True,
    )


def lm(batch_size: int) -> JobTemplate:
    return JobTemplate(
        model=f"LM (batch size {batch_size})",
        command=f"python3 main.py --cuda --data %s/wikitext2 --batch_size {batch_size}",
        working_directory="language_modeling",
        num_steps_arg="--steps",
        distributed=True,
    )


def recommendation(batch_size: int) -> JobTemplate:
    return JobTemplate(
        model=f"Recommendation (batch size {batch_size})",
        command=f"python3 train.py --data_dir %s/ml-20m/pro_sg/ --batch_size {batch_size}",
        working_directory="recommendation",
        num_steps_arg="-n",
    )


def a3c() -> JobTemplate:
    return JobTemplate(
        model="A3C",
        command="python3 main.py --env PongDeterministic-v4 --workers 4 --amsgrad True",
        working_directory="rl",
        num_steps_arg="--max-steps",
        needs_data_dir=False,
    )


def cyclegan() -> JobTemplate:
    return JobTemplate(
        model="CycleGAN",
        command="python3 cyclegan.py --dataset_path %s/monet2photo --decay_epoch 0",
        working_directory="cyclegan",
        num_steps_arg="--n_steps",
    )


def _build_table() -> List[JobTemplate]:
    table: List[JobTemplate] = []
    for bs in [32, 64, 128, 256]:
        table.append(resnet18(bs))
    for bs in [16, 32, 64]:
        table.append(resnet50(bs))
    # Transformer capped at bs 128 (reference avoids bs 256 OOM on a
    # 16 GB V100; the profile carries the same limit).
    for bs in [16, 32, 64, 128]:
        table.append(transformer(bs))
    for bs in [5, 10, 20, 40, 80]:
        table.append(lm(bs))
    for bs in [512, 1024, 2048, 4096, 8192]:
        table.append(recommendation(bs))
    # a3c() and cyclegan() templates exist but stay out of the generator
    # table (non-dynamic, non-distributed), as in the reference.
    return table


JOB_TABLE: List[JobTemplate] = _build_table()

__all__ = ["JobTemplate", "JOB_TABLE", "resnet18", "resnet50", "transformer",
           "lm", "recommendation", "a3c", "cyclegan"]
