"""Which collectives a gloo process group carries on CUDA tensors.

    python3 scripts/gloo_cuda_probe.py          # a machine with one card

DTensor on ranks that share one card must talk over gloo (NCCL takes one
rank a card). For each collective that DTensor's redistributions issue
(the functional collectives) and their ``torch.distributed`` forms, two
fresh gloo ranks on the card run it once on an 8-element float32 CUDA
tensor, each pair in its own processes so that a crash stays there.
Prints one line a rank: its exit code and its result, or the last lines
it wrote (a segmentation fault's Python stack, through faulthandler).
"""
import subprocess
import sys
import tempfile

OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
       "all_to_all_single", "c10d_all_reduce", "c10d_all_gather",
       "c10d_reduce_scatter_tensor")

RANK = r'''
import datetime, faulthandler, sys, torch, torch.distributed as dist
from torch.distributed import _functional_collectives as funcol
faulthandler.enable()
rank, op, store = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=30))
g = dist.group.WORLD
x = torch.arange(8, dtype=torch.float32, device="cuda") + rank
if op == "all_reduce":
    y = funcol.wait_tensor(funcol.all_reduce(x, "sum", g))
elif op == "all_gather_into_tensor":
    y = funcol.wait_tensor(funcol.all_gather_tensor(x, 0, g))
elif op == "reduce_scatter_tensor":
    y = funcol.wait_tensor(funcol.reduce_scatter_tensor(x, "sum", 0, g))
elif op == "all_to_all_single":
    y = funcol.wait_tensor(funcol.all_to_all_single(x, None, None, g))
elif op == "c10d_all_reduce":
    y = x.clone()
    dist.all_reduce(y)
elif op == "c10d_all_gather":
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x)
    y = torch.cat(parts)
else:
    y = torch.empty(4, device="cuda")
    dist.reduce_scatter_tensor(y, x)
torch.cuda.synchronize()
print("RESULT", y.cpu().tolist(), flush=True)
dist.destroy_process_group()
'''


def main():
    for op in OPS:
        with tempfile.TemporaryDirectory() as tmp:
            procs = [subprocess.Popen(
                [sys.executable, "-c", RANK, str(r), op, tmp + "/store"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(2)]
            for r, p in enumerate(procs):
                try:
                    out = p.communicate(timeout=90)[0]
                except subprocess.TimeoutExpired:
                    p.kill()
                    out = p.communicate()[0] + "\ntimed out after 90 s"
                lines = [ln for ln in out.splitlines() if ln.strip()]
                res = [ln for ln in lines if ln.startswith("RESULT")]
                print(f"{op} rank {r} exit {p.returncode}: "
                      + (res[0] if res else " | ".join(lines[-6:]))[:600],
                      flush=True)


if __name__ == "__main__":
    main()
