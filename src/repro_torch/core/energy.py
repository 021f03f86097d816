"""DRAM-chip energy constants, nJ per KB (port of `repro.core.energy`).

  E_AAP    = 1.58 nJ per KB of row data per AAP cycle (Ambit-class ACT+PRE)
  E_access = 60 nJ per KB moved by a conventional read/write stream
  E_io     = 104 nJ per KB crossing the DDR4 interface
"""
E_AAP_NJ_PER_KB = 1.58
E_ACCESS_NJ_PER_KB = 60.0
E_IO_NJ_PER_KB = 104.0
