"""Pipeline stages: run-CC detection and the stage-1 tracking loop."""
