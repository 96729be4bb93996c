"""A frozen copy of the port's plain PyTorch code paths (`icp4dradar_tpu_torch`
at commit 03a0450), one flat module per port module, that the benchmark's
reference runs. It imports nothing of the port, and later changes to the
port do not reach it."""
