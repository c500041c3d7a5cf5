"""The HAST.sh orchestrator."""
