"""What a step should cost on an H100: the kernels' work formulas
(``costs``), a counting dispatch mode (``counter``) and the roofline terms
built from its totals (``analysis``)."""
