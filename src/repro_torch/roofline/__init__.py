"""repro_torch.roofline — what a run costs (port of ``repro/roofline``).

  census.py    FLOPs, bytes, collective bytes and the peak of live bytes of
               one eager run, op by op (the kernels by formula).
  analysis.py  the analytic model FLOPs and the three-term roofline (compute,
               memory, collective) of the dry run's cells, with the H100's
               rates.
"""
