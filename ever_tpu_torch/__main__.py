"""``python -m ever_tpu_torch create <path>`` scaffolds a project
(counterpart of ``ever_tpu/__main__.py``)."""

import argparse

from ever_tpu_torch.util._main import create_project


def create(path: str) -> None:
    create_project(path)


def main():
    parser = argparse.ArgumentParser(prog='ever_tpu_torch')
    sub = parser.add_subparsers(dest='cmd', required=True)
    c = sub.add_parser('create', help='scaffold a new project')
    c.add_argument('path')
    args = parser.parse_args()
    if args.cmd == 'create':
        create_project(args.path)


if __name__ == '__main__':
    main()
