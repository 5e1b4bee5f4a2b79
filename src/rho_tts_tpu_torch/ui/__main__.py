"""Allow ``python -m rho_tts_tpu_torch.ui`` to launch the web UI."""
from . import main

if __name__ == "__main__":  # importing the module (a walk of the package) launches nothing
    main()
