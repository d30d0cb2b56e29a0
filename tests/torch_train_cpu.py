#!/usr/bin/env python
"""``train_torch.py`` on the CPU: ``python tests/torch_train_cpu.py
[train_torch.py flags]`` runs ``train_torch.main(['--device', 'cpu',
*flags])``.

The NAS search and the quality-control re-runs start the training script
as a subprocess and pass every setting as a flag, string values quoted by
``repr`` (``--device 'cpu'`` would name no device), so the tests hand them
this script in place of ``train_torch.py``."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import train_torch  # noqa: E402

if __name__ == '__main__':
    train_torch.main(['--device', 'cpu', *sys.argv[1:]])
