import sys

from tmt_bench.run import main

sys.exit(main())
