"""``python -m inductive_recommendation_tpu_torch ...``: the port's command
line (``main.py``)."""

from inductive_recommendation_tpu_torch.main import main

if __name__ == "__main__":
    main()
