#!/usr/bin/env python3
# Drop-in replacement for the reference script of the same name, on the
# PyTorch/CUDA port.
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from gnss_dsp_tpu_torch.cli.acquire import main
sys.exit(main('glonass-l3ocp', sys.argv[1:]))
