"""The paper's own configuration: the MR-HRC sigmoid unit itself (port of
``repro/configs/paper_sigmoid.py``, its constants copied).

This is not an LM architecture: it is the canonical configuration of the
activation datapath (schedules, fixed-point format) that all ``cordic_*``
act_impls share, exposed here so experiments can reference one source of
truth.
"""
from repro_torch.core.cordic import FixedConfig, MRSchedule, PAPER_FIXED, PAPER_SCHEDULE

ARCH_ID = "paper-sigmoid-mrhrc"

#: Radix-2 j=2..9, radix-4 j=4..7, LVC j=1..14 (paper Sec. 3.1-3.3).
SCHEDULE: MRSchedule = PAPER_SCHEDULE
#: 16-bit Q2.14, truncating datapath shifts, nearest final rounding.
FIXED: FixedConfig = PAPER_FIXED

#: Input contracts.
SIGMOID_DOMAIN = (-1.0, 1.0)
TANH_DOMAIN = (-0.5, 0.5)

#: Paper-reported references (asserted in tests/test_paper_claims.py).
PAPER_MAE = 4.23e-4
PAPER_SLICES = 835
PAPER_DSP = 0
