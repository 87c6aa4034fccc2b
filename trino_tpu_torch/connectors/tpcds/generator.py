"""Deterministic TPC-DS data generator (numpy, vectorized).

The reference ships TPC-DS as a generated connector (plugin/trino-tpcds:
TpcdsMetadata/TpcdsSplitManager over the teradata tpcds lib).  This is a
from-scratch numpy implementation: all 24 standard tables with their full
standard column sets, seeded PCG64 so every run generates identical data.
Money columns use the DOUBLE mapping (the reference's
DecimalTypeMapping.DOUBLE option, plugin/trino-tpcds TpcdsMetadata).

Correctness testing is differential (engine vs sqlite over the SAME
generated rows, tests/test_tpcds.py), so spec-exact dsdgen distributions are
not required; schema shape, key relationships (fact FKs -> dimension SKs,
returns reference sales), calendar correctness of date_dim, and NULL
presence (TPC-DS facts have nullable FKs) are.
"""

from __future__ import annotations

import datetime
import zlib

import numpy as np

from ...data.types import BIGINT, DATE, DOUBLE, INTEGER, VARCHAR, Type

__all__ = ["TPCDS_SCHEMAS", "generate_table", "SCALE_TINY"]

SCALE_TINY = 0.002

_SEED = 0x7D5_2026

_T = {"b": BIGINT, "i": INTEGER, "d": DOUBLE, "s": VARCHAR, "t": DATE}


def _schema(spec: str) -> list[tuple[str, Type]]:
    out = []
    for part in spec.split():
        name, kind = part.rsplit(":", 1)
        out.append((name, _T[kind]))
    return out


TPCDS_SCHEMAS: dict[str, list[tuple[str, Type]]] = {
    "date_dim": _schema(
        "d_date_sk:b d_date_id:s d_date:t d_month_seq:i d_week_seq:i d_quarter_seq:i"
        " d_year:i d_dow:i d_moy:i d_dom:i d_qoy:i d_fy_year:i d_fy_quarter_seq:i"
        " d_fy_week_seq:i d_day_name:s d_quarter_name:s d_holiday:s d_weekend:s"
        " d_following_holiday:s d_first_dom:i d_last_dom:i d_same_day_ly:i"
        " d_same_day_lq:i d_current_day:s d_current_week:s d_current_month:s"
        " d_current_quarter:s d_current_year:s"
    ),
    "time_dim": _schema(
        "t_time_sk:b t_time_id:s t_time:i t_hour:i t_minute:i t_second:i"
        " t_am_pm:s t_shift:s t_sub_shift:s t_meal_time:s"
    ),
    "item": _schema(
        "i_item_sk:b i_item_id:s i_rec_start_date:t i_rec_end_date:t i_item_desc:s"
        " i_current_price:d i_wholesale_cost:d i_brand_id:i i_brand:s i_class_id:i"
        " i_class:s i_category_id:i i_category:s i_manufact_id:i i_manufact:s"
        " i_size:s i_formulation:s i_color:s i_units:s i_container:s"
        " i_manager_id:i i_product_name:s"
    ),
    "customer": _schema(
        "c_customer_sk:b c_customer_id:s c_current_cdemo_sk:b c_current_hdemo_sk:b"
        " c_current_addr_sk:b c_first_shipto_date_sk:b c_first_sales_date_sk:b"
        " c_salutation:s c_first_name:s c_last_name:s c_preferred_cust_flag:s"
        " c_birth_day:i c_birth_month:i c_birth_year:i c_birth_country:s"
        " c_login:s c_email_address:s c_last_review_date_sk:b"
    ),
    "customer_address": _schema(
        "ca_address_sk:b ca_address_id:s ca_street_number:s ca_street_name:s"
        " ca_street_type:s ca_suite_number:s ca_city:s ca_county:s ca_state:s"
        " ca_zip:s ca_country:s ca_gmt_offset:d ca_location_type:s"
    ),
    "customer_demographics": _schema(
        "cd_demo_sk:b cd_gender:s cd_marital_status:s cd_education_status:s"
        " cd_purchase_estimate:i cd_credit_rating:s cd_dep_count:i"
        " cd_dep_employed_count:i cd_dep_college_count:i"
    ),
    "household_demographics": _schema(
        "hd_demo_sk:b hd_income_band_sk:b hd_buy_potential:s hd_dep_count:i"
        " hd_vehicle_count:i"
    ),
    "income_band": _schema("ib_income_band_sk:b ib_lower_bound:i ib_upper_bound:i"),
    "store": _schema(
        "s_store_sk:b s_store_id:s s_rec_start_date:t s_rec_end_date:t"
        " s_closed_date_sk:b s_store_name:s s_number_employees:i s_floor_space:i"
        " s_hours:s s_manager:s s_market_id:i s_geography_class:s"
        " s_market_desc:s s_market_manager:s s_division_id:i s_division_name:s"
        " s_company_id:i s_company_name:s s_street_number:s s_street_name:s"
        " s_street_type:s s_suite_number:s s_city:s s_county:s s_state:s s_zip:s"
        " s_country:s s_gmt_offset:d s_tax_precentage:d"
    ),
    "warehouse": _schema(
        "w_warehouse_sk:b w_warehouse_id:s w_warehouse_name:s w_warehouse_sq_ft:i"
        " w_street_number:s w_street_name:s w_street_type:s w_suite_number:s"
        " w_city:s w_county:s w_state:s w_zip:s w_country:s w_gmt_offset:d"
    ),
    "promotion": _schema(
        "p_promo_sk:b p_promo_id:s p_start_date_sk:b p_end_date_sk:b p_item_sk:b"
        " p_cost:d p_response_target:i p_promo_name:s p_channel_dmail:s"
        " p_channel_email:s p_channel_catalog:s p_channel_tv:s p_channel_radio:s"
        " p_channel_press:s p_channel_event:s p_channel_demo:s p_channel_details:s"
        " p_purpose:s p_discount_active:s"
    ),
    "reason": _schema("r_reason_sk:b r_reason_id:s r_reason_desc:s"),
    "ship_mode": _schema(
        "sm_ship_mode_sk:b sm_ship_mode_id:s sm_type:s sm_code:s sm_carrier:s"
        " sm_contract:s"
    ),
    "call_center": _schema(
        "cc_call_center_sk:b cc_call_center_id:s cc_rec_start_date:t"
        " cc_rec_end_date:t cc_closed_date_sk:b cc_open_date_sk:b cc_name:s"
        " cc_class:s cc_employees:i cc_sq_ft:i cc_hours:s cc_manager:s"
        " cc_mkt_id:i cc_mkt_class:s cc_mkt_desc:s cc_market_manager:s"
        " cc_division:i cc_division_name:s cc_company:i cc_company_name:s"
        " cc_street_number:s cc_street_name:s cc_street_type:s cc_suite_number:s"
        " cc_city:s cc_county:s cc_state:s cc_zip:s cc_country:s cc_gmt_offset:d"
        " cc_tax_percentage:d"
    ),
    "catalog_page": _schema(
        "cp_catalog_page_sk:b cp_catalog_page_id:s cp_start_date_sk:b"
        " cp_end_date_sk:b cp_department:s cp_catalog_number:i"
        " cp_catalog_page_number:i cp_description:s cp_type:s"
    ),
    "web_page": _schema(
        "wp_web_page_sk:b wp_web_page_id:s wp_rec_start_date:t wp_rec_end_date:t"
        " wp_creation_date_sk:b wp_access_date_sk:b wp_autogen_flag:s"
        " wp_customer_sk:b wp_url:s wp_type:s wp_char_count:i wp_link_count:i"
        " wp_image_count:i wp_max_ad_count:i"
    ),
    "web_site": _schema(
        "web_site_sk:b web_site_id:s web_rec_start_date:t web_rec_end_date:t"
        " web_name:s web_open_date_sk:b web_close_date_sk:b web_class:s"
        " web_manager:s web_mkt_id:i web_mkt_class:s web_mkt_desc:s"
        " web_market_manager:s web_company_id:i web_company_name:s"
        " web_street_number:s web_street_name:s web_street_type:s"
        " web_suite_number:s web_city:s web_county:s web_state:s web_zip:s"
        " web_country:s web_gmt_offset:d web_tax_percentage:d"
    ),
    "store_sales": _schema(
        "ss_sold_date_sk:b ss_sold_time_sk:b ss_item_sk:b ss_customer_sk:b"
        " ss_cdemo_sk:b ss_hdemo_sk:b ss_addr_sk:b ss_store_sk:b ss_promo_sk:b"
        " ss_ticket_number:b ss_quantity:i ss_wholesale_cost:d ss_list_price:d"
        " ss_sales_price:d ss_ext_discount_amt:d ss_ext_sales_price:d"
        " ss_ext_wholesale_cost:d ss_ext_list_price:d ss_ext_tax:d"
        " ss_coupon_amt:d ss_net_paid:d ss_net_paid_inc_tax:d ss_net_profit:d"
    ),
    "store_returns": _schema(
        "sr_returned_date_sk:b sr_return_time_sk:b sr_item_sk:b sr_customer_sk:b"
        " sr_cdemo_sk:b sr_hdemo_sk:b sr_addr_sk:b sr_store_sk:b sr_reason_sk:b"
        " sr_ticket_number:b sr_return_quantity:i sr_return_amt:d sr_return_tax:d"
        " sr_return_amt_inc_tax:d sr_fee:d sr_return_ship_cost:d"
        " sr_refunded_cash:d sr_reversed_charge:d sr_store_credit:d sr_net_loss:d"
    ),
    "catalog_sales": _schema(
        "cs_sold_date_sk:b cs_sold_time_sk:b cs_ship_date_sk:b cs_bill_customer_sk:b"
        " cs_bill_cdemo_sk:b cs_bill_hdemo_sk:b cs_bill_addr_sk:b"
        " cs_ship_customer_sk:b cs_ship_cdemo_sk:b cs_ship_hdemo_sk:b"
        " cs_ship_addr_sk:b cs_call_center_sk:b cs_catalog_page_sk:b"
        " cs_ship_mode_sk:b cs_warehouse_sk:b cs_item_sk:b cs_promo_sk:b"
        " cs_order_number:b cs_quantity:i cs_wholesale_cost:d cs_list_price:d"
        " cs_sales_price:d cs_ext_discount_amt:d cs_ext_sales_price:d"
        " cs_ext_wholesale_cost:d cs_ext_list_price:d cs_ext_tax:d cs_coupon_amt:d"
        " cs_ext_ship_cost:d cs_net_paid:d cs_net_paid_inc_tax:d"
        " cs_net_paid_inc_ship:d cs_net_paid_inc_ship_tax:d cs_net_profit:d"
    ),
    "catalog_returns": _schema(
        "cr_returned_date_sk:b cr_returned_time_sk:b cr_item_sk:b"
        " cr_refunded_customer_sk:b cr_refunded_cdemo_sk:b cr_refunded_hdemo_sk:b"
        " cr_refunded_addr_sk:b cr_returning_customer_sk:b cr_returning_cdemo_sk:b"
        " cr_returning_hdemo_sk:b cr_returning_addr_sk:b cr_call_center_sk:b"
        " cr_catalog_page_sk:b cr_ship_mode_sk:b cr_warehouse_sk:b cr_reason_sk:b"
        " cr_order_number:b cr_return_quantity:i cr_return_amount:d cr_return_tax:d"
        " cr_return_amt_inc_tax:d cr_fee:d cr_return_ship_cost:d cr_refunded_cash:d"
        " cr_reversed_charge:d cr_store_credit:d cr_net_loss:d"
    ),
    "web_sales": _schema(
        "ws_sold_date_sk:b ws_sold_time_sk:b ws_ship_date_sk:b ws_item_sk:b"
        " ws_bill_customer_sk:b ws_bill_cdemo_sk:b ws_bill_hdemo_sk:b"
        " ws_bill_addr_sk:b ws_ship_customer_sk:b ws_ship_cdemo_sk:b"
        " ws_ship_hdemo_sk:b ws_ship_addr_sk:b ws_web_page_sk:b ws_web_site_sk:b"
        " ws_ship_mode_sk:b ws_warehouse_sk:b ws_promo_sk:b ws_order_number:b"
        " ws_quantity:i ws_wholesale_cost:d ws_list_price:d ws_sales_price:d"
        " ws_ext_discount_amt:d ws_ext_sales_price:d ws_ext_wholesale_cost:d"
        " ws_ext_list_price:d ws_ext_tax:d ws_coupon_amt:d ws_ext_ship_cost:d"
        " ws_net_paid:d ws_net_paid_inc_tax:d ws_net_paid_inc_ship:d"
        " ws_net_paid_inc_ship_tax:d ws_net_profit:d"
    ),
    "web_returns": _schema(
        "wr_returned_date_sk:b wr_returned_time_sk:b wr_item_sk:b"
        " wr_refunded_customer_sk:b wr_refunded_cdemo_sk:b wr_refunded_hdemo_sk:b"
        " wr_refunded_addr_sk:b wr_returning_customer_sk:b wr_returning_cdemo_sk:b"
        " wr_returning_hdemo_sk:b wr_returning_addr_sk:b wr_web_page_sk:b"
        " wr_reason_sk:b wr_order_number:b wr_return_quantity:i wr_return_amt:d"
        " wr_return_tax:d wr_return_amt_inc_tax:d wr_fee:d wr_return_ship_cost:d"
        " wr_refunded_cash:d wr_reversed_charge:d wr_account_credit:d wr_net_loss:d"
    ),
    "inventory": _schema(
        "inv_date_sk:b inv_item_sk:b inv_warehouse_sk:b inv_quantity_on_hand:i"
    ),
}

# base cardinalities at SF1 (scaled linearly for facts, sub-linearly capped
# for dimensions like dsdgen does)
_BASE_ROWS = {
    "date_dim": 0,  # fixed calendar, not scaled
    "time_dim": 86400,
    "item": 18000,
    "customer": 100_000,
    "customer_address": 50_000,
    "customer_demographics": 19208 * 100,
    "household_demographics": 7200,
    "income_band": 20,
    "store": 12,
    "warehouse": 5,
    "promotion": 300,
    "reason": 35,
    "ship_mode": 20,
    "call_center": 6,
    "catalog_page": 11_718,
    "web_page": 60,
    "web_site": 30,
    "store_sales": 2_880_404,
    "store_returns": 287_514,
    "catalog_sales": 1_441_548,
    "catalog_returns": 144_067,
    "web_sales": 719_384,
    "web_returns": 71_763,
    "inventory": 11_745_000,
}

_CATEGORIES = [
    "Books", "Children", "Electronics", "Home", "Jewelry",
    "Men", "Music", "Shoes", "Sports", "Women",
]
_CLASSES = ["accent", "blazers", "classical", "fiction", "pants", "pop", "romance", "school", "self-help", "shirts"]
_COLORS = ["azure", "beige", "black", "blue", "brown", "green", "ivory", "red", "white", "yellow"]
_STATES = ["CA", "GA", "IL", "MI", "NY", "OH", "TN", "TX", "VA", "WA"]
_COUNTIES = [f"{s} County" for s in ["Adams", "Bronx", "Cook", "Dallas", "Kent", "Lake", "Polk", "Wayne"]]
_EDU = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree", "Advanced Degree", "Unknown"]
_MARITAL = ["M", "S", "D", "W", "U"]
_BUY_POTENTIAL = ["0-500", "501-1000", "1001-5000", "5001-10000", ">10000", "Unknown"]
_DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday"]

_DATE_START = datetime.date(1998, 1, 1)
_DATE_END = datetime.date(2003, 12, 31)
_SK_BASE = 2450815  # julian-ish surrogate base like dsdgen


def _rng(table: str, scale: float) -> np.random.Generator:
    return np.random.Generator(
        np.random.PCG64([_SEED, zlib.crc32(table.encode()), int(scale * 1e6)])
    )


def _rows(table: str, scale: float) -> int:
    base = _BASE_ROWS[table]
    if table in ("store", "warehouse", "call_center", "web_site", "web_page",
                 "income_band", "reason", "ship_mode", "promotion"):
        return max(2, int(base * min(1.0, max(scale * 20, 0.2))))
    if table in ("item", "customer", "customer_address", "time_dim",
                 "household_demographics", "customer_demographics", "catalog_page"):
        return max(10, int(base * min(1.0, max(scale * 5, scale))))
    return max(10, int(base * scale))


def _money(rng, n, lo, hi):
    return rng.integers(int(lo * 100), int(hi * 100) + 1, size=n) / 100.0


def _ids(prefix: str, keys: np.ndarray) -> np.ndarray:
    return np.asarray([f"{prefix}{k:016d}"[:16] for k in keys], dtype=object)


def _pick(rng, vocab, n):
    return np.asarray(vocab, dtype=object)[rng.integers(0, len(vocab), size=n)]


def _fk(rng, n, dim_rows, null_frac=0.04):
    """Foreign keys into a dimension's SK space, with NULLs (dsdgen does)."""
    fk = rng.integers(1, dim_rows + 1, size=n).astype(np.int64)
    nulls = rng.random(n) < null_frac
    return np.where(nulls, -1, fk), nulls  # -1 + validity handled by caller


def generate_table(table: str, scale: float) -> dict[str, np.ndarray]:
    gen = {
        "date_dim": _gen_date_dim,
        "time_dim": _gen_time_dim,
        "item": _gen_item,
        "customer": _gen_customer,
        "customer_address": _gen_customer_address,
        "customer_demographics": _gen_customer_demographics,
        "household_demographics": _gen_household_demographics,
        "income_band": _gen_income_band,
        "store": _gen_store,
        "warehouse": _gen_warehouse,
        "promotion": _gen_promotion,
        "reason": _gen_reason,
        "ship_mode": _gen_ship_mode,
        "call_center": _gen_call_center,
        "catalog_page": _gen_catalog_page,
        "web_page": _gen_web_page,
        "web_site": _gen_web_site,
        "store_sales": _gen_store_sales,
        "store_returns": _gen_store_returns,
        "catalog_sales": _gen_catalog_sales,
        "catalog_returns": _gen_catalog_returns,
        "web_sales": _gen_web_sales,
        "web_returns": _gen_web_returns,
        "inventory": _gen_inventory,
    }[table]
    data = gen(scale)
    # normalize: every schema column present, in order
    out = {}
    for name, t in TPCDS_SCHEMAS[table]:
        if name in data:
            out[name] = data[name]
        else:  # filler for columns no query in the suite touches
            n = len(next(iter(data.values())))
            out[name] = (
                np.asarray(["" for _ in range(n)], dtype=object)
                if t.is_string
                else np.zeros(n, dtype=t.np_dtype)
            )
    return out


def _date_dim_size() -> int:
    return (_DATE_END - _DATE_START).days + 1


def _gen_date_dim(scale: float):
    n = _date_dim_size()
    dates = [_DATE_START + datetime.timedelta(days=i) for i in range(n)]
    epoch = datetime.date(1970, 1, 1)
    dow = np.asarray([(d.weekday() + 1) % 7 for d in dates], dtype=np.int32)
    return {
        "d_date_sk": np.arange(_SK_BASE, _SK_BASE + n, dtype=np.int64),
        "d_date_id": _ids("D", np.arange(n)),
        "d_date": np.asarray([(d - epoch).days for d in dates], dtype=np.int32),
        "d_month_seq": np.asarray([(d.year - 1990) * 12 + d.month - 1 for d in dates], dtype=np.int32),
        "d_week_seq": np.asarray([((d - _DATE_START).days // 7) for d in dates], dtype=np.int32),
        "d_quarter_seq": np.asarray([(d.year - 1990) * 4 + (d.month - 1) // 3 for d in dates], dtype=np.int32),
        "d_year": np.asarray([d.year for d in dates], dtype=np.int32),
        "d_dow": dow,
        "d_moy": np.asarray([d.month for d in dates], dtype=np.int32),
        "d_dom": np.asarray([d.day for d in dates], dtype=np.int32),
        "d_qoy": np.asarray([(d.month - 1) // 3 + 1 for d in dates], dtype=np.int32),
        "d_fy_year": np.asarray([d.year for d in dates], dtype=np.int32),
        "d_day_name": np.asarray([_DAY_NAMES[(d.weekday() + 1) % 7] for d in dates], dtype=object),
        "d_quarter_name": np.asarray([f"{d.year}Q{(d.month - 1) // 3 + 1}" for d in dates], dtype=object),
        "d_holiday": np.asarray(["N"] * n, dtype=object),
        "d_weekend": np.asarray(["Y" if (d.weekday() >= 5) else "N" for d in dates], dtype=object),
    }


def _gen_time_dim(scale: float):
    n = _rows("time_dim", scale)
    secs = np.linspace(0, 86399, n).astype(np.int32)
    hour = secs // 3600
    return {
        "t_time_sk": np.arange(n, dtype=np.int64),
        "t_time_id": _ids("T", np.arange(n)),
        "t_time": secs,
        "t_hour": hour.astype(np.int32),
        "t_minute": ((secs % 3600) // 60).astype(np.int32),
        "t_second": (secs % 60).astype(np.int32),
        "t_am_pm": np.where(hour < 12, "AM", "PM").astype(object),
        "t_shift": np.where(hour < 8, "first", np.where(hour < 16, "second", "third")).astype(object),
    }


def _gen_item(scale: float):
    n = _rows("item", scale)
    rng = _rng("item", scale)
    sk = np.arange(1, n + 1, dtype=np.int64)
    manufact_id = rng.integers(1, 1000, size=n).astype(np.int32)
    brand_id = rng.integers(1, 10, size=n).astype(np.int32) * 1000000 + manufact_id
    cat_i = rng.integers(0, len(_CATEGORIES), size=n)
    price = _money(rng, n, 0.09, 99.99)
    return {
        "i_item_sk": sk,
        "i_item_id": _ids("I", sk),
        "i_item_desc": _pick(rng, ["promising", "popular", "rare", "standard", "special"], n)
        + " " + _pick(rng, _COLORS, n) + " item",
        "i_current_price": price,
        "i_wholesale_cost": np.round(price * 0.6, 2),
        "i_brand_id": brand_id,
        "i_brand": np.asarray([f"brand#{b % 100}" for b in brand_id], dtype=object),
        "i_class_id": rng.integers(1, 17, size=n).astype(np.int32),
        "i_class": _pick(rng, _CLASSES, n),
        "i_category_id": (cat_i + 1).astype(np.int32),
        "i_category": np.asarray(_CATEGORIES, dtype=object)[cat_i],
        "i_manufact_id": manufact_id,
        "i_manufact": np.asarray([f"manufact#{m}" for m in manufact_id], dtype=object),
        "i_size": _pick(rng, ["small", "medium", "large", "extra large", "N/A", "petite"], n),
        "i_color": _pick(rng, _COLORS, n),
        "i_units": _pick(rng, ["Each", "Box", "Case", "Dozen", "Gross"], n),
        "i_container": _pick(rng, ["Unknown"], n),
        "i_manager_id": rng.integers(1, 101, size=n).astype(np.int32),
        "i_product_name": _pick(rng, ["able", "ought", "eing", "bar", "cally"], n),
    }


def _gen_customer(scale: float):
    n = _rows("customer", scale)
    rng = _rng("customer", scale)
    sk = np.arange(1, n + 1, dtype=np.int64)
    n_addr = _rows("customer_address", scale)
    n_cd = _rows("customer_demographics", scale)
    n_hd = _rows("household_demographics", scale)
    nd = _date_dim_size()
    return {
        "c_customer_sk": sk,
        "c_customer_id": _ids("C", sk),
        "c_current_cdemo_sk": rng.integers(1, n_cd + 1, size=n).astype(np.int64),
        "c_current_hdemo_sk": rng.integers(1, n_hd + 1, size=n).astype(np.int64),
        "c_current_addr_sk": rng.integers(1, n_addr + 1, size=n).astype(np.int64),
        # first-sale/first-shipto dates land in the date_dim sk range so
        # Q64-class joins (c_first_sales_date_sk = d2.d_date_sk) resolve
        "c_first_sales_date_sk": rng.integers(
            _SK_BASE, _SK_BASE + nd, size=n
        ).astype(np.int64),
        "c_first_shipto_date_sk": rng.integers(
            _SK_BASE, _SK_BASE + nd, size=n
        ).astype(np.int64),
        "c_salutation": _pick(rng, ["Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir"], n),
        "c_first_name": _pick(rng, ["James", "Mary", "John", "Linda", "Robert", "Susan", "David", "Karen"], n),
        "c_last_name": _pick(rng, ["Smith", "Jones", "Brown", "Davis", "Miller", "Wilson", "Moore", "Taylor"], n),
        "c_preferred_cust_flag": _pick(rng, ["Y", "N"], n),
        "c_birth_day": rng.integers(1, 29, size=n).astype(np.int32),
        "c_birth_month": rng.integers(1, 13, size=n).astype(np.int32),
        "c_birth_year": rng.integers(1930, 1993, size=n).astype(np.int32),
        "c_birth_country": _pick(rng, ["UNITED STATES", "CANADA", "MEXICO", "FRANCE", "JAPAN"], n),
        "c_email_address": _pick(rng, ["a", "b", "c"], n),
    }


def _gen_customer_address(scale: float):
    n = _rows("customer_address", scale)
    rng = _rng("customer_address", scale)
    sk = np.arange(1, n + 1, dtype=np.int64)
    return {
        "ca_address_sk": sk,
        "ca_address_id": _ids("A", sk),
        "ca_street_number": np.asarray([str(v) for v in rng.integers(1, 1000, size=n)], dtype=object),
        "ca_street_name": _pick(rng, ["Main", "Oak", "Pine", "Maple", "Cedar", "Elm"], n),
        "ca_street_type": _pick(rng, ["St", "Ave", "Blvd", "Way", "Ct"], n),
        "ca_city": _pick(rng, ["Midway", "Fairview", "Oakland", "Salem", "Georgetown", "Marion"], n),
        "ca_county": _pick(rng, _COUNTIES, n),
        "ca_state": _pick(rng, _STATES, n),
        "ca_zip": np.asarray([f"{z:05d}" for z in rng.integers(10000, 99999, size=n)], dtype=object),
        "ca_country": np.asarray(["United States"] * n, dtype=object),
        "ca_gmt_offset": _pick(rng, [-5.0, -6.0, -7.0, -8.0], n).astype(np.float64),
        "ca_location_type": _pick(rng, ["apartment", "condo", "single family"], n),
    }


def _gen_customer_demographics(scale: float):
    n = _rows("customer_demographics", scale)
    rng = _rng("customer_demographics", scale)
    sk = np.arange(1, n + 1, dtype=np.int64)
    return {
        "cd_demo_sk": sk,
        "cd_gender": _pick(rng, ["M", "F"], n),
        "cd_marital_status": _pick(rng, _MARITAL, n),
        "cd_education_status": _pick(rng, _EDU, n),
        "cd_purchase_estimate": (rng.integers(1, 20, size=n) * 500).astype(np.int32),
        "cd_credit_rating": _pick(rng, ["Low Risk", "High Risk", "Good", "Unknown"], n),
        "cd_dep_count": rng.integers(0, 7, size=n).astype(np.int32),
        "cd_dep_employed_count": rng.integers(0, 7, size=n).astype(np.int32),
        "cd_dep_college_count": rng.integers(0, 7, size=n).astype(np.int32),
    }


def _gen_household_demographics(scale: float):
    n = _rows("household_demographics", scale)
    rng = _rng("household_demographics", scale)
    return {
        "hd_demo_sk": np.arange(1, n + 1, dtype=np.int64),
        "hd_income_band_sk": rng.integers(1, 21, size=n).astype(np.int64),
        "hd_buy_potential": _pick(rng, _BUY_POTENTIAL, n),
        "hd_dep_count": rng.integers(0, 10, size=n).astype(np.int32),
        "hd_vehicle_count": rng.integers(-1, 5, size=n).astype(np.int32),
    }


def _gen_income_band(scale: float):
    n = 20
    lower = np.arange(n, dtype=np.int32) * 10000
    return {
        "ib_income_band_sk": np.arange(1, n + 1, dtype=np.int64),
        "ib_lower_bound": lower + 1,
        "ib_upper_bound": lower + 10000,
    }


def _gen_store(scale: float):
    n = _rows("store", scale)
    rng = _rng("store", scale)
    sk = np.arange(1, n + 1, dtype=np.int64)
    return {
        "s_store_sk": sk,
        "s_store_id": _ids("S", sk),
        "s_store_name": _pick(rng, ["ought", "able", "ese", "anti", "cally", "ation", "eing", "bar"], n),
        "s_number_employees": rng.integers(200, 301, size=n).astype(np.int32),
        "s_floor_space": rng.integers(5_000_000, 10_000_001, size=n).astype(np.int32),
        "s_hours": _pick(rng, ["8AM-8AM", "8AM-4PM", "8AM-12AM"], n),
        "s_manager": _pick(rng, ["William Ward", "Scott Smith", "Edwin Adams", "David White"], n),
        "s_market_id": rng.integers(1, 11, size=n).astype(np.int32),
        "s_city": _pick(rng, ["Midway", "Fairview"], n),
        "s_county": _pick(rng, _COUNTIES, n),
        "s_state": _pick(rng, _STATES[:4], n),
        "s_zip": np.asarray([f"{z:05d}" for z in rng.integers(10000, 99999, size=n)], dtype=object),
        "s_country": np.asarray(["United States"] * n, dtype=object),
        "s_gmt_offset": np.full(n, -5.0),
        "s_tax_precentage": _pick(rng, [0.00, 0.01, 0.02, 0.03, 0.05], n).astype(np.float64),
    }


def _gen_warehouse(scale: float):
    n = _rows("warehouse", scale)
    rng = _rng("warehouse", scale)
    sk = np.arange(1, n + 1, dtype=np.int64)
    return {
        "w_warehouse_sk": sk,
        "w_warehouse_id": _ids("W", sk),
        "w_warehouse_name": _pick(rng, ["Conventional childr", "Important issues liv", "Doors canno", "Bad cards must make", "Operations cannot"], n),
        "w_warehouse_sq_ft": rng.integers(50_000, 1_000_000, size=n).astype(np.int32),
        "w_city": _pick(rng, ["Midway", "Fairview"], n),
        "w_county": _pick(rng, _COUNTIES, n),
        "w_state": _pick(rng, _STATES[:4], n),
        "w_country": np.asarray(["United States"] * n, dtype=object),
        "w_gmt_offset": np.full(n, -5.0),
    }


def _gen_promotion(scale: float):
    n = _rows("promotion", scale)
    rng = _rng("promotion", scale)
    sk = np.arange(1, n + 1, dtype=np.int64)
    nd = _date_dim_size()
    start = rng.integers(_SK_BASE, _SK_BASE + nd - 60, size=n).astype(np.int64)
    return {
        "p_promo_sk": sk,
        "p_promo_id": _ids("P", sk),
        "p_start_date_sk": start,
        "p_end_date_sk": start + rng.integers(10, 60, size=n),
        "p_item_sk": rng.integers(1, _rows("item", scale) + 1, size=n).astype(np.int64),
        "p_cost": np.full(n, 1000.0),
        "p_response_target": np.ones(n, dtype=np.int32),
        "p_promo_name": _pick(rng, ["anti", "ought", "bar", "ese"], n),
        "p_channel_dmail": _pick(rng, ["Y", "N"], n),
        "p_channel_email": _pick(rng, ["N"], n),
        "p_channel_tv": _pick(rng, ["N"], n),
        "p_channel_event": _pick(rng, ["Y", "N"], n),
        "p_discount_active": _pick(rng, ["N"], n),
    }


def _gen_reason(scale: float):
    n = _rows("reason", scale)
    sk = np.arange(1, n + 1, dtype=np.int64)
    rng = _rng("reason", scale)
    return {
        "r_reason_sk": sk,
        "r_reason_id": _ids("R", sk),
        "r_reason_desc": _pick(rng, ["Package was damaged", "Stopped working", "Did not fit", "Not the product that was ordred", "Parts missing"], n),
    }


def _gen_ship_mode(scale: float):
    n = _rows("ship_mode", scale)
    sk = np.arange(1, n + 1, dtype=np.int64)
    rng = _rng("ship_mode", scale)
    return {
        "sm_ship_mode_sk": sk,
        "sm_ship_mode_id": _ids("SM", sk),
        "sm_type": _pick(rng, ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY", "LIBRARY"], n),
        "sm_code": _pick(rng, ["AIR", "SURFACE", "SEA"], n),
        "sm_carrier": _pick(rng, ["UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "ZOUROS"], n),
    }


def _gen_call_center(scale: float):
    n = _rows("call_center", scale)
    rng = _rng("call_center", scale)
    sk = np.arange(1, n + 1, dtype=np.int64)
    return {
        "cc_call_center_sk": sk,
        "cc_call_center_id": _ids("CC", sk),
        "cc_name": _pick(rng, ["NY Metro", "Mid Atlantic", "Pacific NW", "North Midwest"], n),
        "cc_class": _pick(rng, ["small", "medium", "large"], n),
        "cc_employees": rng.integers(1, 7, size=n).astype(np.int32),
        "cc_manager": _pick(rng, ["Bob Belcher", "Felipe Perkins", "Mark Hightower", "Larry Mccray"], n),
        "cc_county": _pick(rng, _COUNTIES, n),
        "cc_state": _pick(rng, _STATES[:4], n),
        "cc_country": np.asarray(["United States"] * n, dtype=object),
        "cc_gmt_offset": np.full(n, -5.0),
        "cc_tax_percentage": _pick(rng, [0.00, 0.01, 0.02, 0.05, 0.1, 0.12], n).astype(np.float64),
    }


def _gen_catalog_page(scale: float):
    n = _rows("catalog_page", scale)
    rng = _rng("catalog_page", scale)
    sk = np.arange(1, n + 1, dtype=np.int64)
    return {
        "cp_catalog_page_sk": sk,
        "cp_catalog_page_id": _ids("CP", sk),
        "cp_department": np.asarray(["DEPARTMENT"] * n, dtype=object),
        "cp_catalog_number": rng.integers(1, 110, size=n).astype(np.int32),
        "cp_catalog_page_number": rng.integers(1, 109, size=n).astype(np.int32),
        "cp_type": _pick(rng, ["bi-annual", "quarterly", "monthly"], n),
    }


def _gen_web_page(scale: float):
    n = _rows("web_page", scale)
    rng = _rng("web_page", scale)
    sk = np.arange(1, n + 1, dtype=np.int64)
    return {
        "wp_web_page_sk": sk,
        "wp_web_page_id": _ids("WP", sk),
        "wp_autogen_flag": _pick(rng, ["Y", "N"], n),
        "wp_url": np.asarray(["http://www.foo.com"] * n, dtype=object),
        "wp_type": _pick(rng, ["ad", "dynamic", "feedback", "general", "order", "protected", "welcome"], n),
        "wp_char_count": rng.integers(100, 8000, size=n).astype(np.int32),
        "wp_link_count": rng.integers(2, 25, size=n).astype(np.int32),
        "wp_image_count": rng.integers(1, 7, size=n).astype(np.int32),
    }


def _gen_web_site(scale: float):
    n = _rows("web_site", scale)
    rng = _rng("web_site", scale)
    sk = np.arange(1, n + 1, dtype=np.int64)
    return {
        "web_site_sk": sk,
        "web_site_id": _ids("WS", sk),
        "web_name": _pick(rng, ["site_0", "site_1", "site_2", "site_3", "site_4"], n),
        "web_class": np.asarray(["Unknown"] * n, dtype=object),
        "web_manager": _pick(rng, ["Albert Leung", "Kiel Healy", "David Lamontagne"], n),
        "web_company_name": _pick(rng, ["pri", "ought", "able", "ese", "anti", "cally"], n),
        "web_state": _pick(rng, _STATES[:4], n),
        "web_country": np.asarray(["United States"] * n, dtype=object),
        "web_gmt_offset": np.full(n, -5.0),
        "web_tax_percentage": _pick(rng, [0.00, 0.01, 0.02, 0.05, 0.1, 0.12], n).astype(np.float64),
    }


def _sales_money(rng, n, qty):
    wholesale = _money(rng, n, 1.00, 100.00)
    list_price = np.round(wholesale * (1 + rng.integers(10, 101, size=n) / 100.0), 2)
    sales_price = np.round(list_price * (1 - rng.integers(0, 81, size=n) / 100.0), 2)
    ext_sales = np.round(sales_price * qty, 2)
    ext_list = np.round(list_price * qty, 2)
    ext_wholesale = np.round(wholesale * qty, 2)
    discount = np.round(ext_list - ext_sales, 2)
    tax = np.round(ext_sales * 0.05, 2)
    coupon = np.where(rng.random(n) < 0.1, np.round(ext_sales * 0.1, 2), 0.0)
    net_paid = np.round(ext_sales - coupon, 2)
    return {
        "wholesale": wholesale, "list": list_price, "sales": sales_price,
        "ext_discount": discount, "ext_sales": ext_sales,
        "ext_wholesale": ext_wholesale, "ext_list": ext_list, "tax": tax,
        "coupon": coupon, "net_paid": net_paid,
        "net_paid_tax": np.round(net_paid + tax, 2),
        "net_profit": np.round(net_paid - ext_wholesale, 2),
    }


def _gen_store_sales(scale: float):
    n = _rows("store_sales", scale)
    rng = _rng("store_sales", scale)
    nd = _date_dim_size()
    qty = rng.integers(1, 101, size=n).astype(np.int32)
    m = _sales_money(rng, n, qty)
    date_fk, _ = _fk(rng, n, nd)
    date_fk = np.where(date_fk > 0, date_fk + _SK_BASE - 1, date_fk)
    out = {
        "ss_sold_date_sk": date_fk,
        "ss_sold_time_sk": _fk(rng, n, _rows("time_dim", scale))[0],
        "ss_item_sk": rng.integers(1, _rows("item", scale) + 1, size=n).astype(np.int64),
        "ss_customer_sk": _fk(rng, n, _rows("customer", scale))[0],
        "ss_cdemo_sk": _fk(rng, n, _rows("customer_demographics", scale))[0],
        "ss_hdemo_sk": _fk(rng, n, _rows("household_demographics", scale))[0],
        "ss_addr_sk": _fk(rng, n, _rows("customer_address", scale))[0],
        "ss_store_sk": _fk(rng, n, _rows("store", scale))[0],
        "ss_promo_sk": _fk(rng, n, _rows("promotion", scale))[0],
        "ss_ticket_number": np.arange(1, n + 1, dtype=np.int64),
        "ss_quantity": qty,
        "ss_wholesale_cost": m["wholesale"],
        "ss_list_price": m["list"],
        "ss_sales_price": m["sales"],
        "ss_ext_discount_amt": m["ext_discount"],
        "ss_ext_sales_price": m["ext_sales"],
        "ss_ext_wholesale_cost": m["ext_wholesale"],
        "ss_ext_list_price": m["ext_list"],
        "ss_ext_tax": m["tax"],
        "ss_coupon_amt": m["coupon"],
        "ss_net_paid": m["net_paid"],
        "ss_net_paid_inc_tax": m["net_paid_tax"],
        "ss_net_profit": m["net_profit"],
    }
    return out


def _gen_store_returns(scale: float):
    """Returns reference actual sale rows (dsdgen derives each return from a
    parent sale), so ss_item_sk = sr_item_sk AND ss_ticket_number =
    sr_ticket_number joins resolve — the Q64/q64lite/q93 join shape."""
    n = _rows("store_returns", scale)
    rng = _rng("store_returns", scale)
    n_sales = _rows("store_sales", scale)
    nd = _date_dim_size()
    qty = rng.integers(1, 50, size=n).astype(np.int32)
    amt = _money(rng, n, 1.0, 500.0)
    date_fk, _ = _fk(rng, n, nd)
    from . import tpcds_data  # session cache; safe at call time

    sales = tpcds_data("store_sales", scale)
    sale_row = rng.integers(0, n_sales, size=n)
    cash = np.round(amt * rng.random(n) * 0.5, 2)
    charge = np.round(amt * rng.random(n) * 0.3, 2)
    return {
        "sr_returned_date_sk": np.where(date_fk > 0, date_fk + _SK_BASE - 1, date_fk),
        "sr_item_sk": sales["ss_item_sk"][sale_row],
        # the returning customer is the purchasing customer (dsdgen does the
        # same) — q25/q29-class ss x sr joins key on it
        "sr_customer_sk": sales["ss_customer_sk"][sale_row],
        "sr_store_sk": _fk(rng, n, _rows("store", scale))[0],
        "sr_reason_sk": _fk(rng, n, _rows("reason", scale))[0],
        "sr_ticket_number": sales["ss_ticket_number"][sale_row],
        "sr_return_quantity": qty,
        "sr_return_amt": amt,
        "sr_return_tax": np.round(amt * 0.05, 2),
        "sr_return_amt_inc_tax": np.round(amt * 1.05, 2),
        "sr_fee": _money(rng, n, 0.5, 100.0),
        "sr_return_ship_cost": _money(rng, n, 0.0, 50.0),
        "sr_refunded_cash": cash,
        "sr_reversed_charge": charge,
        "sr_store_credit": np.round(amt - cash - charge, 2).clip(min=0.0),
        "sr_net_loss": _money(rng, n, 0.5, 300.0),
    }


def _gen_catalog_sales(scale: float):
    n = _rows("catalog_sales", scale)
    rng = _rng("catalog_sales", scale)
    nd = _date_dim_size()
    qty = rng.integers(1, 101, size=n).astype(np.int32)
    m = _sales_money(rng, n, qty)
    date_fk, _ = _fk(rng, n, nd)
    ship_cost = _money(rng, n, 0.0, 100.0)
    return {
        "cs_sold_date_sk": np.where(date_fk > 0, date_fk + _SK_BASE - 1, date_fk),
        "cs_ship_date_sk": np.where(date_fk > 0, date_fk + _SK_BASE - 1 + rng.integers(2, 30, size=n), -1),
        "cs_bill_customer_sk": _fk(rng, n, _rows("customer", scale))[0],
        "cs_bill_cdemo_sk": _fk(rng, n, _rows("customer_demographics", scale))[0],
        "cs_bill_hdemo_sk": _fk(rng, n, _rows("household_demographics", scale))[0],
        "cs_bill_addr_sk": _fk(rng, n, _rows("customer_address", scale))[0],
        "cs_ship_customer_sk": _fk(rng, n, _rows("customer", scale))[0],
        "cs_ship_addr_sk": _fk(rng, n, _rows("customer_address", scale))[0],
        "cs_call_center_sk": _fk(rng, n, _rows("call_center", scale))[0],
        "cs_catalog_page_sk": _fk(rng, n, _rows("catalog_page", scale))[0],
        "cs_ship_mode_sk": _fk(rng, n, _rows("ship_mode", scale))[0],
        "cs_warehouse_sk": _fk(rng, n, _rows("warehouse", scale))[0],
        "cs_item_sk": rng.integers(1, _rows("item", scale) + 1, size=n).astype(np.int64),
        "cs_promo_sk": _fk(rng, n, _rows("promotion", scale))[0],
        "cs_order_number": np.arange(1, n + 1, dtype=np.int64),
        "cs_quantity": qty,
        "cs_wholesale_cost": m["wholesale"],
        "cs_list_price": m["list"],
        "cs_sales_price": m["sales"],
        "cs_ext_discount_amt": m["ext_discount"],
        "cs_ext_sales_price": m["ext_sales"],
        "cs_ext_wholesale_cost": m["ext_wholesale"],
        "cs_ext_list_price": m["ext_list"],
        "cs_ext_tax": m["tax"],
        "cs_coupon_amt": m["coupon"],
        "cs_ext_ship_cost": ship_cost,
        "cs_net_paid": m["net_paid"],
        "cs_net_paid_inc_tax": m["net_paid_tax"],
        "cs_net_paid_inc_ship": np.round(m["net_paid"] + ship_cost, 2),
        "cs_net_paid_inc_ship_tax": np.round(m["net_paid_tax"] + ship_cost, 2),
        "cs_net_profit": m["net_profit"],
    }


def _gen_catalog_returns(scale: float):
    """Returns reference actual catalog_sales rows (cr_item_sk +
    cr_order_number pairs come from a parent sale) so Q64's cs_ui CTE join
    cs_item_sk = cr_item_sk AND cs_order_number = cr_order_number resolves."""
    n = _rows("catalog_returns", scale)
    rng = _rng("catalog_returns", scale)
    nd = _date_dim_size()
    amt = _money(rng, n, 1.0, 500.0)
    date_fk, _ = _fk(rng, n, nd)
    from . import tpcds_data  # session cache; safe at call time

    sales = tpcds_data("catalog_sales", scale)
    sale_row = rng.integers(0, _rows("catalog_sales", scale), size=n)
    cash = np.round(amt * rng.random(n) * 0.5, 2)
    charge = np.round(amt * rng.random(n) * 0.3, 2)
    return {
        "cr_returned_date_sk": np.where(date_fk > 0, date_fk + _SK_BASE - 1, date_fk),
        "cr_item_sk": sales["cs_item_sk"][sale_row],
        "cr_refunded_customer_sk": _fk(rng, n, _rows("customer", scale))[0],
        "cr_returning_customer_sk": _fk(rng, n, _rows("customer", scale))[0],
        "cr_call_center_sk": _fk(rng, n, _rows("call_center", scale))[0],
        "cr_catalog_page_sk": _fk(rng, n, _rows("catalog_page", scale))[0],
        "cr_reason_sk": _fk(rng, n, _rows("reason", scale))[0],
        "cr_order_number": sales["cs_order_number"][sale_row],
        "cr_return_quantity": rng.integers(1, 50, size=n).astype(np.int32),
        "cr_return_amount": amt,
        "cr_return_tax": np.round(amt * 0.05, 2),
        "cr_return_amt_inc_tax": np.round(amt * 1.05, 2),
        "cr_fee": _money(rng, n, 0.5, 100.0),
        "cr_refunded_cash": cash,
        "cr_reversed_charge": charge,
        "cr_store_credit": np.round(amt - cash - charge, 2).clip(min=0.0),
        "cr_net_loss": _money(rng, n, 0.5, 300.0),
    }


def _gen_web_sales(scale: float):
    n = _rows("web_sales", scale)
    rng = _rng("web_sales", scale)
    nd = _date_dim_size()
    qty = rng.integers(1, 101, size=n).astype(np.int32)
    m = _sales_money(rng, n, qty)
    date_fk, _ = _fk(rng, n, nd)
    ship_cost = _money(rng, n, 0.0, 100.0)
    return {
        "ws_sold_date_sk": np.where(date_fk > 0, date_fk + _SK_BASE - 1, date_fk),
        "ws_ship_date_sk": np.where(date_fk > 0, date_fk + _SK_BASE - 1 + rng.integers(2, 30, size=n), -1),
        "ws_item_sk": rng.integers(1, _rows("item", scale) + 1, size=n).astype(np.int64),
        "ws_bill_customer_sk": _fk(rng, n, _rows("customer", scale))[0],
        "ws_bill_addr_sk": _fk(rng, n, _rows("customer_address", scale))[0],
        "ws_ship_customer_sk": _fk(rng, n, _rows("customer", scale))[0],
        "ws_web_page_sk": _fk(rng, n, _rows("web_page", scale))[0],
        "ws_web_site_sk": _fk(rng, n, _rows("web_site", scale))[0],
        "ws_ship_mode_sk": _fk(rng, n, _rows("ship_mode", scale))[0],
        "ws_warehouse_sk": _fk(rng, n, _rows("warehouse", scale))[0],
        "ws_promo_sk": _fk(rng, n, _rows("promotion", scale))[0],
        "ws_order_number": np.arange(1, n + 1, dtype=np.int64),
        "ws_quantity": qty,
        "ws_wholesale_cost": m["wholesale"],
        "ws_list_price": m["list"],
        "ws_sales_price": m["sales"],
        "ws_ext_discount_amt": m["ext_discount"],
        "ws_ext_sales_price": m["ext_sales"],
        "ws_ext_wholesale_cost": m["ext_wholesale"],
        "ws_ext_list_price": m["ext_list"],
        "ws_ext_tax": m["tax"],
        "ws_coupon_amt": m["coupon"],
        "ws_ext_ship_cost": ship_cost,
        "ws_net_paid": m["net_paid"],
        "ws_net_paid_inc_tax": m["net_paid_tax"],
        "ws_net_paid_inc_ship": np.round(m["net_paid"] + ship_cost, 2),
        "ws_net_paid_inc_ship_tax": np.round(m["net_paid_tax"] + ship_cost, 2),
        "ws_net_profit": m["net_profit"],
    }


def _gen_web_returns(scale: float):
    n = _rows("web_returns", scale)
    rng = _rng("web_returns", scale)
    nd = _date_dim_size()
    amt = _money(rng, n, 1.0, 500.0)
    date_fk, _ = _fk(rng, n, nd)
    return {
        "wr_returned_date_sk": np.where(date_fk > 0, date_fk + _SK_BASE - 1, date_fk),
        "wr_item_sk": rng.integers(1, _rows("item", scale) + 1, size=n).astype(np.int64),
        "wr_refunded_customer_sk": _fk(rng, n, _rows("customer", scale))[0],
        "wr_returning_customer_sk": _fk(rng, n, _rows("customer", scale))[0],
        "wr_web_page_sk": _fk(rng, n, _rows("web_page", scale))[0],
        "wr_reason_sk": _fk(rng, n, _rows("reason", scale))[0],
        "wr_order_number": rng.integers(1, _rows("web_sales", scale) + 1, size=n).astype(np.int64),
        "wr_return_quantity": rng.integers(1, 50, size=n).astype(np.int32),
        "wr_return_amt": amt,
        "wr_return_tax": np.round(amt * 0.05, 2),
        "wr_return_amt_inc_tax": np.round(amt * 1.05, 2),
        "wr_fee": _money(rng, n, 0.5, 100.0),
        "wr_net_loss": _money(rng, n, 0.5, 300.0),
    }


def _gen_inventory(scale: float):
    n = _rows("inventory", scale)
    rng = _rng("inventory", scale)
    nd = _date_dim_size()
    return {
        "inv_date_sk": (rng.integers(0, nd // 7, size=n) * 7 + _SK_BASE).astype(np.int64),
        "inv_item_sk": rng.integers(1, _rows("item", scale) + 1, size=n).astype(np.int64),
        "inv_warehouse_sk": rng.integers(1, _rows("warehouse", scale) + 1, size=n).astype(np.int64),
        "inv_quantity_on_hand": rng.integers(0, 1000, size=n).astype(np.int32),
    }
