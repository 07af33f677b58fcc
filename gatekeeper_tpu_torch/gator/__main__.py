from gatekeeper_tpu_torch.gator.cli import main

import sys

sys.exit(main())
