"""`python -m repro_torch.analysis` — the torchlint CLI (see runner.py)."""
from repro_torch.analysis.runner import main

main()
