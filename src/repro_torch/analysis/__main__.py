"""``python -m repro_torch.analysis`` — the port's analysis CLI.

Usage:
  python -m repro_torch.analysis lint [PATH...]   AST rules (default: the port)
  python -m repro_torch.analysis lint --rules     print the rule table
  python -m repro_torch.analysis kernels [--device N]
                                                  CUDA launch checker
  python -m repro_torch.analysis audit [--device cpu] [--update] ...
                                                  trace audit vs the golden

Exit code 1 on any finding, violation or divergence.
"""
import sys


def main(argv) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "kernels":
        from repro_torch.analysis.kernel_check import main as run
    elif cmd == "audit":
        from repro_torch.analysis.trace_audit import main as run
    elif cmd == "lint":
        from repro_torch.analysis.lint import main as run
    else:
        print(f"unknown command {cmd!r}\n{__doc__}")
        return 2
    return run(rest)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
