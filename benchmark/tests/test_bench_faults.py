"""A run driven on the CPU past the harness's look for a card, at tiny
widths, with the cell's own limits: sound, `correct` comes out true;
with the timed path broken underneath, false, once for each fault a
one-chip training cell can have (`benchmark/faults.py`); and the
control, the reference in the program's place with its bf16 products in
fp8, fails one of the numbers. A fault planted only once the warm-up
has run is caught too: the checked steps are the window's."""
import pytest

from benchmark import check, faults, generator, harness, spec

SEED = 2**31 + 21


# ResNet-50's `loss_gap` limit (1.2e-4) is set by the fp8 control at the
# cell's own size on the card, where sound runs read up to 6.1e-5; the
# tiny inputs' bf16 convolutions on the CPU read 1.4e-4 to 2.4e-4 in sound
# runs. Here that one number is held to the limit the faults alone would set
# (the geometric mean of 6.1e-5 and the half-batch fault's 5.65e-3).
CPU_LIMITS = {"resnet50.imagenet_b128": {"loss_gap": 6e-4}}


def tiny(workload):
    """The cell at its widths, cut for the CPU: the Transformer to one
    layer a side and 512 token slots, ResNet-50 to 32 images of 112 x
    112 (at 16 of 64 x 64 the sound run's median change gap is over the
    cell's limit); its limits as they are but for `CPU_LIMITS`."""
    cell = spec.load(workload)
    if cell.config["driver"] == "seq2seq_transformer":
        cell.config.update(num_layers=1, max_len=64)
        cell.mix.update(buckets=[[32, 16]], population=2000, pool_batches=4,
                        source_length={"law": "uniform", "low": 16, "high": 32})
    else:
        cell.mix.update(batch=32, height=112, width=112, pool_batches=3)
    cell.limits["limits"].update(CPU_LIMITS.get(workload, {}))
    return cell


WORKLOADS = ["transformer_base.doc2048", "transformer_base.multi30k_b768",
             "resnet50.imagenet_b128"]


def after_warm_up(fault):
    """`fault`, planted at the first step after the warm-up: a path the
    window takes and the warm-up does not."""
    def patch(trainer):
        step, calls = trainer.train_step, [0]

        def late(*batch):
            calls[0] += 1
            if calls[0] == harness.WARM_STEPS + 1:
                fault(trainer)
            return step(*batch)

        trainer.train_step = late
    return patch


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    result = harness.run(tiny(workload), SEED, 0.2, False, "cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(workload, fault):
    result = harness.run(tiny(workload), SEED, 0.2, False, "cpu", patch=faults.FAULTS[fault])
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("workload", [WORKLOADS[0], WORKLOADS[2]])
def test_fault_after_warm_up_is_not_correct(workload, fault):
    result = harness.run(tiny(workload), SEED, 0.2, False, "cpu",
                         patch=after_warm_up(faults.FAULTS[fault]))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    cell = tiny(workload)
    pool = generator.make(cell.mix, cell.config, SEED, "cpu")[:harness.FIRST_STEPS]
    ref = harness.reference_readings(cell, SEED, pool, pool[0].tensors[0].device)
    ctl = harness.reference_readings(cell, SEED, pool, pool[0].tensors[0].device, "fp8")
    numbers, _ = check.compare(ctl, ref)
    assert not check.verdict(numbers, cell.limits["limits"]), numbers
