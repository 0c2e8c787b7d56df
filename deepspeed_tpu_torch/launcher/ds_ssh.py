"""ds_ssh — run a shell command on every host in the hostfile
(counterpart of ``deepspeed_tpu/launcher/ds_ssh.py``).

Capability parity with the reference's ``bin/ds_ssh`` (pdsh wrapper over the
hostfile). Usage: ``ds_ssh [-H hostfile] -- <command...>``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from .runner import fetch_hostfile


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, cmd = argv[:split], argv[split + 1:]
    else:
        cmd = []
    p = argparse.ArgumentParser(prog="ds_ssh")
    p.add_argument("-H", "--hostfile", default="/job/hostfile")
    args = p.parse_args(argv)
    if not cmd:
        p.error("pass the command after '--'")
    pool = fetch_hostfile(args.hostfile)
    hosts = list(pool) or ["localhost"]
    rc = 0
    for host in hosts:
        print(f"----- {host} -----")
        full = cmd if host == "localhost" else \
            ["ssh", "-o", "StrictHostKeyChecking=no", host] + cmd
        r = subprocess.run(full)
        rc = rc or r.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
