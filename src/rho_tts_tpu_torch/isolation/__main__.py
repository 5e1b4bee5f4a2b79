"""Allow ``python -m rho_tts_tpu_torch.isolation`` to run the worker loop."""
from rho_tts_tpu_torch.isolation.worker import main

if __name__ == "__main__":  # importing the module (a walk of the package) starts no loop
    main()
