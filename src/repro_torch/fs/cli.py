"""``branchfs`` CLI — standalone branch management (paper §4.4).

The port's copy of ``repro/fs/cli.py``.

Usage (mirrors ``branchfs create/commit/abort``)::

    python -m repro_torch.fs.cli --root ws init
    python -m repro_torch.fs.cli --root ws create --parent base --name fix-a
    python -m repro_torch.fs.cli --root ws write  --branch fix-a --path main.py --data 'print(1)'
    python -m repro_torch.fs.cli --root ws read   --branch fix-a --path main.py
    python -m repro_torch.fs.cli --root ws commit --branch fix-a
    python -m repro_torch.fs.cli --root ws abort  --branch fix-b
    python -m repro_torch.fs.cli --root ws ls     --branch base
    python -m repro_torch.fs.cli --root ws status --branch fix-a
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.fs.branchfs import BranchFS


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="branchfs")
    p.add_argument("--root", required=True, help="store root directory")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("init")
    c = sub.add_parser("create")
    c.add_argument("--parent", default="base")
    c.add_argument("--name", default=None)
    c.add_argument("-n", type=int, default=1)
    for name in ("commit", "abort", "ls", "status"):
        s = sub.add_parser(name)
        s.add_argument("--branch", required=True)
    w = sub.add_parser("write")
    w.add_argument("--branch", required=True)
    w.add_argument("--path", required=True)
    w.add_argument("--data", required=True)
    r = sub.add_parser("read")
    r.add_argument("--branch", required=True)
    r.add_argument("--path", required=True)
    d = sub.add_parser("rm")
    d.add_argument("--branch", required=True)
    d.add_argument("--path", required=True)

    args = p.parse_args(argv)
    fs = BranchFS(args.root)

    if args.cmd == "init":
        print(f"initialized BranchFS at {args.root}")
    elif args.cmd == "create":
        names = fs.create(parent=args.parent, name=args.name, n=args.n)
        print("\n".join(names))
    elif args.cmd == "commit":
        print(fs.commit(args.branch))
    elif args.cmd == "abort":
        fs.abort(args.branch)
        print("aborted")
    elif args.cmd == "write":
        fs.write(args.branch, args.path, args.data.encode())
        print("ok")
    elif args.cmd == "read":
        sys.stdout.buffer.write(fs.read(args.branch, args.path))
    elif args.cmd == "rm":
        fs.delete(args.branch, args.path)
        print("ok")
    elif args.cmd == "ls":
        print("\n".join(fs.listdir(args.branch)))
    elif args.cmd == "status":
        print(fs.status(args.branch))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
