from tpusparse.formats.csr import CsrMatrix  # noqa: F401
from tpusparse.formats.ell import EllMatrix  # noqa: F401
from tpusparse.formats.sell import SellMatrix  # noqa: F401
from tpusparse.formats.awsp import AwspMatrix  # noqa: F401
from tpusparse.formats.bsr import BsrMatrix  # noqa: F401
from tpusparse.formats.binned import BinnedSellMatrix  # noqa: F401
from tpusparse.formats.tcsr import TcsrMatrix  # noqa: F401
from tpusparse.formats.rsell import RsellMatrix  # noqa: F401
from tpusparse.formats.dia import DiaMatrix  # noqa: F401
from tpusparse.formats.auto import auto_format, matrix_stats, matrix_stats_csr  # noqa: F401
