"""Every scaling axis on one host: the port of
``examples/scale_parallelism.py``.

``dryrun.dryrun_multichip(8)`` starts eight ranks of one Gloo group on
this host (sharing the card, or on the CPU with ``device="cpu"``) and
runs one real forward and backward of each parallelism the port ships:
DP, TP (gspmd), FSDP, the sp kv ring, GPipe, expert-parallel MoE, the
Megatron block on kernel 3 per rank, the pp trainer, 3-D dp×pp×tp, the
moe_ep trainer and the sp trainer.

``python -m torch.distributed.run --nproc_per_node N -m
devt_tpu_torch.main --dp N --mp 2`` (or ``--dp_mode fsdp``) drives the
training entry point the same way.
"""

from devt_tpu_torch import dryrun


def main(argv=None, device=None):
    del argv  # the journey takes no arguments
    dryrun.dryrun_multichip(8, device=device)
    print("all eleven parallelism legs ran one fwd+bwd step")


if __name__ == "__main__":
    main()
